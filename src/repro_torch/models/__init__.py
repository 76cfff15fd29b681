from .model import Model, build  # noqa: F401
