"""Dataset registry: ``dataset_dict`` maps --dataset_name to a dataset.

Blender is ported; phototourism and llff raise until their loaders are
(ROADMAP A.6).
"""
from .blender import BlenderDataset  # noqa: F401
from .sampler import RayBatcher  # noqa: F401


def _not_ported(name):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"the {name} dataset is not ported yet (ROADMAP A.6)")
    return build


dataset_dict = {
    "blender": BlenderDataset,
    "phototourism": _not_ported("phototourism"),
    "llff": _not_ported("llff"),
}
