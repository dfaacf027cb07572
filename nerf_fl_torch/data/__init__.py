"""Dataset registry: ``dataset_dict`` maps --dataset_name to a dataset."""
from .blender import BlenderDataset  # noqa: F401
from .llff import LLFFDataset  # noqa: F401
from .phototourism import PhototourismDataset  # noqa: F401
from .sampler import RayBatcher  # noqa: F401

dataset_dict = {
    "blender": BlenderDataset,
    "phototourism": PhototourismDataset,
    "llff": LLFFDataset,
}
