from .svc import SVCInference  # noqa: F401
