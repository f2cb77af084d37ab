"""ortho-sfm-tpu: Structure-from-Motion for orthographic multi-view images in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference C++
pipeline OrthoSfM (kai-neumann/OrthoSfM): SIFT feature detection + exhaustive
pairwise matching with geometric verification, feature-track building,
group-wise incremental pose initialization via RANSAC'd Tomasi-Kanade
factorization, orthographic ray triangulation, and incremental + global bundle
adjustment under four camera parameterizations.

Instead of OpenMP threads and Ceres, all numeric work is expressed as batched /
vmapped / sharded array programs: tracks, observations and RANSAC hypotheses
are dense padded tensors that shard across a device mesh; the
bundle-adjustment normal equations are Schur-reduced over point blocks with
`psum` collectives assembling the camera system.
"""

__version__ = "0.1.0"

# SfM geometry cannot tolerate reduced-precision float32 matmuls. On NVIDIA
# GPUs XLA may run an f32 dot or convolution in TF32 (a 10-bit mantissa, about
# three decimal digits): rotation products lose orthogonality, the Gaussian
# pyramid swamps the DoG contrast threshold (0.02/3), and the BA normal
# equations lose the curvature detail LM needs near convergence. Pin every
# precision-unspecified dot/conv to full f32; code that can safely trade
# precision for speed opts in explicitly with a precision= argument.
import jax as _jax

_jax.config.update("jax_default_matmul_precision", "highest")

from orthosfm_tpu.config import (BundleAdjustConfig, FilterConfig,
                                 MatchingConfig, RansacConfig,
                                 ReconstructionConfig, SolverType)

__all__ = [
    "BundleAdjustConfig", "FilterConfig", "MatchingConfig", "RansacConfig",
    "ReconstructionConfig", "SolverType", "__version__",
]


def reconstruct(config: ReconstructionConfig, verbose: bool = True):
    """Top-level reconstruction (lazy import keeps `import orthosfm_tpu` light)."""
    from orthosfm_tpu.pipeline.reconstruct import reconstruct as _reconstruct

    return _reconstruct(config, verbose=verbose)
