from .embeddings import embedding_lookup, init_embedding, validate_vocab
from .mlp import NeRF, NeRFConfig, apply_nerf, init_nerf, num_params
from .poses import (LearnPose, all_poses, gauge_transform, init_learn_pose,
                    learned_poses, perturb_poses, pose_errors, pose_for)

__all__ = ["NeRF", "NeRFConfig", "apply_nerf", "init_nerf", "num_params",
           "embedding_lookup", "init_embedding", "validate_vocab",
           "LearnPose", "all_poses", "init_learn_pose", "pose_for",
           "learned_poses", "perturb_poses", "gauge_transform",
           "pose_errors"]
