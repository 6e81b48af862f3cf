"""Video evaluation (port of ``seervideoldm_tpu/evaluation``): FVD / KVD
through I3D, the Inception Score through C3D, and CLIPSIM."""
from .fvd import FVDEvaluator, frechet_distance, polynomial_mmd, preprocess_videos
from .i3d import InceptionI3d, load_i3d_params
from .inception_score import inception_score

__all__ = [
    "preprocess_videos",
    "frechet_distance",
    "polynomial_mmd",
    "FVDEvaluator",
    "InceptionI3d",
    "load_i3d_params",
    "inception_score",
]
