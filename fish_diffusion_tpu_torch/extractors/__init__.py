from .crepe import CrepePitchExtractor  # noqa: F401
from .feature import ChineseHubert, ChineseHubertSoft, ContentVec, HubertSoft  # noqa: F401
from .pitch import (  # noqa: F401
    AutocorrPitchExtractor,
    ParselMouthPitchExtractor,
    PyinPitchExtractor,
    YinPitchExtractor,
)
from .world import DioPitchExtractor, HarvestPitchExtractor  # noqa: F401
