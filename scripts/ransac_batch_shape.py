"""RANSAC-F results against the batch shape they were computed at.

    python scripts/ransac_batch_shape.py [--pairs 16] [--split 4]

Verifies `pairs` synthetic view pairs (256 correspondences each, 2 px
noise, 30 % outliers; MatchingConfig's 1000 iterations and 0.0015
threshold) with ops.ransac_f.ransac_fundamental_batched_keys, each pair
with its own key:

1. as one batch, and as `split` batches of pairs/split (the per-device
   shape of a plain split over that many devices), on the first device;
2. through parallel.matching_sharded.run_pair_chunks without a mesh and
   with a mesh over all devices.

Prints, for each comparison, the pairs whose inlier count differs and the
inlier flags that differ. On a GPU the first comparison can differ: the
compiled float32 arithmetic depends on the batch shape, and borderline
inliers flip. The second must not: each device runs the one-device chunk
shape. Exits non-zero if it does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_pairs(n_pairs: int, m: int = 256, noise_px: float = 2.0,
                    outliers: float = 0.3, width: int = 2048, seed: int = 0):
    """(p1, p2, valid) in MVE-normalized coordinates for n_pairs pairs of
    orthographic views of one synthetic point cloud."""
    from orthosfm_tpu.data import synthetic

    n_views = 2
    while n_views * (n_views - 1) // 2 < n_pairs:
        n_views += 1
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(m), seed=seed,
                                    num_views=n_views, width=width,
                                    height=width)
    obs = np.asarray(ds.tracks.obs, np.float64)  # (m, V, 2) pixels
    rng = np.random.default_rng(seed)
    pairs = [(i, j) for i in range(n_views) for j in range(i + 1, n_views)]
    p1 = np.zeros((n_pairs, m, 2), np.float32)
    p2 = np.zeros((n_pairs, m, 2), np.float32)
    for k, (i, j) in enumerate(pairs[:n_pairs]):
        a = obs[:, i] + rng.normal(0.0, noise_px, (m, 2))
        b = obs[:, j] + rng.normal(0.0, noise_px, (m, 2))
        bad = rng.random(m) < outliers
        b[bad] = rng.uniform(0, width, (int(bad.sum()), 2))
        p1[k] = (a + 0.5 - width / 2) / width
        p2[k] = (b + 0.5 - width / 2) / width
    valid = np.asarray(ds.tracks.obs_mask)[:, :2].all(axis=1)
    return p1, p2, np.broadcast_to(valid, (n_pairs, m)).copy()


def _diff(a, b) -> dict:
    return {"pairs_with_other_counts": int(np.sum(a.num_inliers
                                                  != b.num_inliers)),
            "inlier_flags_differing": int(np.sum(a.inliers != b.inliers)),
            "inlier_flags": int(np.sum(a.inliers | b.inliers))}


def compare(n_pairs: int = 16, split: int = 4, iterations: int = 1000,
            threshold: float = 0.0015) -> dict:
    import functools

    import jax

    from orthosfm_tpu.ops import ransac_f
    from orthosfm_tpu.parallel import matching_sharded, mesh as mesh_mod

    p1, p2, valid = synthetic_pairs(n_pairs)
    keys = jax.random.split(jax.random.PRNGKey(0), n_pairs)
    fn = functools.partial(ransac_f.ransac_fundamental_batched_keys,
                           iterations=iterations, threshold=threshold)
    pull = lambda r: jax.tree_util.tree_map(np.asarray, r)

    whole = pull(fn(p1, p2, valid, keys))
    step = -(-n_pairs // split)
    parts = [pull(fn(p1[s:s + step], p2[s:s + step], valid[s:s + step],
                     keys[s:s + step])) for s in range(0, n_pairs, step)]
    pieces = jax.tree_util.tree_map(lambda *x: np.concatenate(x), *parts)

    make_args = lambda idx: (p1[idx], p2[idx], valid[idx],
                             keys[jax.numpy.asarray(idx)])
    one = matching_sharded.run_pair_chunks(fn, make_args, n_pairs, n_pairs)
    mesh = mesh_mod.make_mesh(jax.device_count())
    sharded = matching_sharded.run_pair_chunks(fn, make_args, n_pairs,
                                               n_pairs, mesh)
    return {"device": jax.devices()[0].device_kind,
            "devices": jax.device_count(), "pairs": n_pairs, "split": split,
            "one_batch_vs_split": _diff(whole, pieces),
            "one_device_vs_mesh": _diff(one, sharded)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=16)
    p.add_argument("--split", type=int, default=4)
    args = p.parse_args(argv)
    out = compare(args.pairs, args.split)
    print(json.dumps(out))
    return 1 if out["one_device_vs_mesh"]["inlier_flags_differing"] else 0


if __name__ == "__main__":
    sys.exit(main())
