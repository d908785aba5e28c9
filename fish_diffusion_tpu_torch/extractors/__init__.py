from .feature import HubertSoft  # noqa: F401
