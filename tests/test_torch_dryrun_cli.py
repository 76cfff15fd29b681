"""The port's dry-run CLI behaves as the reference's
(``repro/launch/dryrun.py::main``): a cell whose record exists is read
back and printed ``[cached]`` unless ``--force``; a failing cell is
printed ``[FAIL]`` with its traceback, the run goes on past it, lists
the failures and returns 1; with no ``--out`` the records go to
``ARTIFACTS``."""
import json

from repro_torch.launch import dryrun

ARCH, SHAPE = "stablelm-1.6b", "decode_32k"
RECORD = f"{ARCH}_{SHAPE}_h100.json"


def _run(capsys, *argv):
    rc = dryrun.main(["--arch", ARCH, "--shape", SHAPE, *argv])
    return rc, capsys.readouterr().out


def test_second_run_is_cached(tmp_path, capsys):
    rc, out = _run(capsys, "--out", str(tmp_path))
    assert rc == 0 and "[ok]" in out
    path = tmp_path / RECORD
    before = path.stat().st_mtime_ns, path.read_text()
    rc, out = _run(capsys, "--out", str(tmp_path))
    assert rc == 0
    assert f"[cached] {ARCH} x {SHAPE} x h100: ok" in out
    assert "[ok]" not in out
    assert (path.stat().st_mtime_ns, path.read_text()) == before


def test_force_recomputes(tmp_path, capsys):
    path = tmp_path / RECORD
    path.write_text(json.dumps({"arch": ARCH, "shape": SHAPE,
                                "mesh": "h100", "status": "stale"}))
    rc, out = _run(capsys, "--out", str(tmp_path))
    assert rc == 0 and "[cached]" in out and "stale" in out
    assert json.loads(path.read_text())["status"] == "stale"
    rc, out = _run(capsys, "--out", str(tmp_path), "--force")
    assert rc == 0 and "[cached]" not in out and "[ok]" in out
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["memory"]["peak_bytes"] > 0


def test_failing_cell_does_not_stop_the_run(tmp_path, capsys):
    rc = dryrun.main(["--arch", f"no-such-arch,{ARCH}", "--shape",
                      f"{SHAPE},train_4k", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert f"[FAIL] no-such-arch x {SHAPE} x h100" in out
    assert "Traceback" in out
    assert "FAILURES: ['no-such-arch x decode_32k x h100', " \
        "'no-such-arch x train_4k x h100']" in out
    assert "dry-run complete." not in out
    # the good cells after the failing ones are written
    for shape in (SHAPE, "train_4k"):
        rec = json.loads((tmp_path / f"{ARCH}_{shape}_h100.json")
                         .read_text())
        assert rec["status"] == "ok"
    assert not list(tmp_path.glob("no-such-arch*"))
    # the failures are recomputed, never cached
    rc = dryrun.main(["--arch", f"no-such-arch,{ARCH}", "--shape", SHAPE,
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and "[FAIL] no-such-arch" in out
    assert f"[cached] {ARCH} x {SHAPE} x h100: ok" in out


def test_default_out_is_artifacts(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path / "dryrun_h100")
    rc, out = _run(capsys)
    assert rc == 0 and "dry-run complete." in out
    rec = json.loads((tmp_path / "dryrun_h100" / RECORD).read_text())
    assert rec["arch"] == ARCH and rec["status"] == "ok"
    rc, out = _run(capsys)
    assert rc == 0 and f"[cached] {ARCH} x {SHAPE} x h100: ok" in out
