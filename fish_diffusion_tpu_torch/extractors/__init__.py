from .feature import HubertSoft  # noqa: F401
from .world import HarvestPitchExtractor  # noqa: F401
