"""Model zoo of the port: importing the package registers every ported model."""

from learnablepoolingmethods_torch.models import attention, frame_level, video_level  # noqa: F401
from learnablepoolingmethods_torch.models.base import (  # noqa: F401
    create_model,
    find_class_by_name,
    list_models,
)
