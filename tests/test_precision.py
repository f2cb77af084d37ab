"""Matmul-precision regression guard.

On NVIDIA GPUs, precision-unspecified f32 dots/convs may run in TF32 (a
10-bit mantissa, ~1e-3 relative error). That silently breaks SfM: rotation
compositions lose orthogonality, the SIFT Gaussian pyramid swamps the DoG
contrast threshold (0.02/S ≈ 0.0067), and matching degrades while a CPU suite
stays green. The package pins jax_default_matmul_precision at import; this
test guards the pin.
"""

import jax

import orthosfm_tpu  # noqa: F401  (the import applies the pin)


def test_default_matmul_precision_pinned():
    assert jax.config.jax_default_matmul_precision == "highest"
