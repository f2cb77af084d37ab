"""Feature tracks as dense padded tensors.

The reference stores tracks as ragged `std::vector<Track>` with per-feature
linear searches (src/data_structures/track.h:21-107). Here every list
operation becomes a mask update on fixed-capacity arrays:

    obs[T, V, 2]    pixel position of track t in view v
    obs_mask[T, V]  does track t contain a feature for view v
    alive[T]        track-level validity (padding + outlier filtering)

The reference's core list primitive `filterTracksToAvailableCameras`
(src/util/common.cpp:85-139) with its onlyFullSizeTracks / keepAdditionalCamera
modes becomes boolean reductions over obs_mask columns.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from orthosfm_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class TrackSet:
    obs: jnp.ndarray  # (T, V, 2) float32 pixels
    obs_mask: jnp.ndarray  # (T, V) bool
    colors: jnp.ndarray  # (T, V, 3) uint8
    local_ids: jnp.ndarray  # (T, V) int32
    global_ids: jnp.ndarray  # (T, V) int32
    points: jnp.ndarray  # (T, 4) float32 homogeneous
    has_point: jnp.ndarray  # (T,) bool
    alive: jnp.ndarray  # (T,) bool
    view_ids: jnp.ndarray  # (V,) int32 — column → view id

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def num_views(self) -> int:
        return self.obs.shape[1]

    def count(self):
        return jnp.sum(self.alive)

    def feature_counts(self):
        """Number of features per track, 0 for dead tracks."""
        return jnp.sum(self.obs_mask & self.alive[:, None], axis=1)


def empty(capacity: int, num_views: int, view_ids=None) -> TrackSet:
    if view_ids is None:
        view_ids = np.arange(num_views)
    return TrackSet(
        obs=jnp.zeros((capacity, num_views, 2), jnp.float32),
        obs_mask=jnp.zeros((capacity, num_views), bool),
        colors=jnp.zeros((capacity, num_views, 3), jnp.uint8),
        local_ids=jnp.full((capacity, num_views), -1, jnp.int32),
        global_ids=jnp.full((capacity, num_views), -1, jnp.int32),
        points=jnp.zeros((capacity, 4), jnp.float32),
        has_point=jnp.zeros((capacity,), bool),
        alive=jnp.zeros((capacity,), bool),
        view_ids=jnp.asarray(view_ids, jnp.int32),
    )


def from_feature_lists(track_list, view_ids, capacity: int | None = None) -> TrackSet:
    """Build a TrackSet from a Python list of tracks.

    track_list: iterable of tracks; each track is a list of features
    (view_id, local_id, global_id, x, y, r, g, b). Equivalent to the reference's
    loadTracksFromFile product (src/matching/matching_io.cpp:52-95).
    """
    view_ids = np.asarray(view_ids, np.int32)
    col = {int(v): i for i, v in enumerate(view_ids)}
    n_views = len(view_ids)
    n = len(track_list)
    cap = capacity or max(n, 1)
    if n > cap:
        import warnings

        warnings.warn(f"track capacity {cap} < {n} tracks; dropping {n - cap}")
        track_list = track_list[:cap]
        n = cap

    obs = np.zeros((cap, n_views, 2), np.float32)
    obs_mask = np.zeros((cap, n_views), bool)
    colors = np.zeros((cap, n_views, 3), np.uint8)
    local_ids = np.full((cap, n_views), -1, np.int32)
    global_ids = np.full((cap, n_views), -1, np.int32)
    alive = np.zeros((cap,), bool)
    for t, features in enumerate(track_list):
        alive[t] = True
        for f in features:
            vid, lid, gid, x, y = int(f[0]), int(f[1]), int(f[2]), float(f[3]), float(f[4])
            rgb = tuple(int(c) for c in f[5:8]) if len(f) >= 8 else (0, 0, 0)
            v = col[vid]
            obs[t, v] = (x, y)
            obs_mask[t, v] = True
            colors[t, v] = rgb
            local_ids[t, v] = lid
            global_ids[t, v] = gid
    return TrackSet(
        obs=jnp.asarray(obs),
        obs_mask=jnp.asarray(obs_mask),
        colors=jnp.asarray(colors),
        local_ids=jnp.asarray(local_ids),
        global_ids=jnp.asarray(global_ids),
        points=jnp.zeros((cap, 4), jnp.float32),
        has_point=jnp.zeros((cap,), bool),
        alive=jnp.asarray(alive),
        view_ids=jnp.asarray(view_ids),
    )


def from_flat_arrays(counts, vid, lid, gid, xy, rgb, view_ids,
                     capacity: int | None = None) -> TrackSet:
    """Vectorized TrackSet construction from flat per-feature arrays
    (the fast path used with the native tracks.txt parser; exactly
    equivalent to from_feature_lists on the same data).

    counts: (T,) features per track; vid/lid/gid: (F,); xy: (F, 2);
    rgb: (F, 3)."""
    view_ids = np.asarray(view_ids, np.int32)
    n_views = len(view_ids)
    n = len(counts)
    cap = capacity or max(n, 1)
    if n > cap:
        import warnings

        warnings.warn(f"track capacity {cap} < {n} tracks; dropping {n - cap}")
        keep_feats = int(np.sum(counts[:cap]))
        counts = counts[:cap]
        vid, lid, gid = vid[:keep_feats], lid[:keep_feats], gid[:keep_feats]
        xy, rgb = xy[:keep_feats], rgb[:keep_feats]
        n = cap

    order = np.argsort(view_ids, kind="stable")
    cols = order[np.searchsorted(view_ids[order], vid)]
    t_idx = np.repeat(np.arange(n), counts)

    obs = np.zeros((cap, n_views, 2), np.float32)
    obs_mask = np.zeros((cap, n_views), bool)
    colors = np.zeros((cap, n_views, 3), np.uint8)
    local_ids = np.full((cap, n_views), -1, np.int32)
    global_ids = np.full((cap, n_views), -1, np.int32)
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    obs[t_idx, cols] = xy
    obs_mask[t_idx, cols] = True
    colors[t_idx, cols] = rgb
    local_ids[t_idx, cols] = lid
    global_ids[t_idx, cols] = gid.astype(np.int32)
    return TrackSet(
        obs=jnp.asarray(obs),
        obs_mask=jnp.asarray(obs_mask),
        colors=jnp.asarray(colors),
        local_ids=jnp.asarray(local_ids),
        global_ids=jnp.asarray(global_ids),
        points=jnp.zeros((cap, 4), jnp.float32),
        has_point=jnp.zeros((cap,), bool),
        alive=jnp.asarray(alive),
        view_ids=jnp.asarray(view_ids),
    )


def to_feature_lists(tracks: TrackSet):
    """Inverse of from_feature_lists (for file IO). Returns python lists."""
    obs = np.asarray(tracks.obs)
    mask = np.asarray(tracks.obs_mask)
    colors = np.asarray(tracks.colors)
    lids = np.asarray(tracks.local_ids)
    gids = np.asarray(tracks.global_ids)
    alive = np.asarray(tracks.alive)
    vids = np.asarray(tracks.view_ids)
    out = []
    for t in range(tracks.capacity):
        if not alive[t]:
            continue
        feats = []
        for v in range(tracks.num_views):
            if mask[t, v]:
                feats.append(
                    (
                        int(vids[v]), int(lids[t, v]), int(gids[t, v]),
                        float(obs[t, v, 0]), float(obs[t, v, 1]),
                        int(colors[t, v, 0]), int(colors[t, v, 1]), int(colors[t, v, 2]),
                    )
                )
        out.append(feats)
    return out


# ---------------------------------------------------------------------------
# Mask-algebra equivalents of the reference's track filtering


_HOST_VIEW_ID_CACHE: "weakref.WeakKeyDictionary" = None  # type: ignore


def host_view_ids(view_ids) -> np.ndarray:
    """view_ids as a host numpy array, cached per device buffer.

    view_ids is immutable structural metadata read by host-side helpers on
    every pipeline step; fetching it from the device each time would drain
    the device queue with a host sync per step."""
    global _HOST_VIEW_ID_CACHE
    if isinstance(view_ids, np.ndarray):
        return view_ids
    if _HOST_VIEW_ID_CACHE is None:
        import weakref

        _HOST_VIEW_ID_CACHE = weakref.WeakKeyDictionary()
    try:
        cached = _HOST_VIEW_ID_CACHE.get(view_ids)
    except TypeError:  # unhashable/non-weakref-able (tracers)
        return np.asarray(view_ids)
    if cached is None:
        cached = np.asarray(view_ids)
        try:
            _HOST_VIEW_ID_CACHE[view_ids] = cached
        except TypeError:
            pass
    return cached


def columns_for_view_ids(tracks: TrackSet, ids):
    """Map a list of view ids to column indices (host-side helper)."""
    vids = host_view_ids(tracks.view_ids)
    lookup = {int(v): i for i, v in enumerate(vids)}
    return np.asarray([lookup[int(i)] for i in ids], np.int32)


def full_size_mask(tracks: TrackSet, cols):
    """Tracks containing features for ALL the given columns
    (= filterTracksToAvailableCameras(..., onlyFullSizeTracks=true),
    reference: src/util/common.cpp:110-121)."""
    cols = jnp.asarray(cols)
    return tracks.alive & jnp.all(tracks.obs_mask[:, cols], axis=1)


def shared_mask(tracks: TrackSet, cols, min_features: int = 2):
    """Tracks with ≥ min_features features among the given columns
    (= onlyFullSizeTracks=false branch, reference: common.cpp:122-133)."""
    cols = jnp.asarray(cols)
    n = jnp.sum(tracks.obs_mask[:, cols], axis=1)
    return tracks.alive & (n >= min_features)


def restrict_to_columns(tracks: TrackSet, cols, only_full_size: bool,
                        keep_additional: bool) -> TrackSet:
    """Dense analog of filterTracksToAvailableCameras (common.cpp:85-139).

    Instead of building new lists, returns a TrackSet whose ``alive`` mask keeps
    qualifying tracks and (unless keep_additional) whose obs_mask zeroes
    features outside ``cols``.
    """
    cols = jnp.asarray(cols)
    if only_full_size:
        keep = full_size_mask(tracks, cols)
    else:
        keep = shared_mask(tracks, cols)
    if keep_additional:
        return tracks.replace(alive=keep)
    col_mask = jnp.zeros((tracks.num_views,), bool).at[cols].set(True)
    return tracks.replace(alive=keep, obs_mask=tracks.obs_mask & col_mask[None, :])


def incidence(tracks: TrackSet):
    """(T, V) float incidence matrix for group scoring (alive tracks only)."""
    return (tracks.obs_mask & tracks.alive[:, None]).astype(jnp.float32)
