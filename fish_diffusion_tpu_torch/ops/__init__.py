from .masking import get_mask_from_lengths
from .pitch import pitch_to_scale
from .schedule import get_noise_schedule_list
from .tensor import repeat_expand_np

__all__ = [
    "get_mask_from_lengths",
    "get_noise_schedule_list",
    "pitch_to_scale",
    "repeat_expand_np",
]
