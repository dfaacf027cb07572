from .sampler import RayBatcher  # noqa: F401
