"""Serving on the port: the single-model continuous-batching engine
(:mod:`.engine`), the contention-aware multi-tenant gateway
(:mod:`.gateway`), co-serving plans (:mod:`.concurrent`) and the
virtual-time fleet (:mod:`.fleet`)."""
