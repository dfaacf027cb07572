from .embeddings import embedding_lookup, init_embedding, validate_vocab
from .mlp import NeRF, NeRFConfig, apply_nerf, init_nerf, num_params
from .poses import LearnPose, all_poses, init_learn_pose, pose_for

__all__ = ["NeRF", "NeRFConfig", "apply_nerf", "init_nerf", "num_params",
           "embedding_lookup", "init_embedding", "validate_vocab",
           "LearnPose", "all_poses", "init_learn_pose", "pose_for"]
