"""Canonical on-disk locations of the serve control plane.

The port's copy of `state_dir` and `local_clusters_dir` of
`skypilot_tpu/utils/paths.py` (:6-12, :25-28): the serve state database
and the controllers' logs live under `state_dir()`, and each replica
cluster the launch seam runs on this host keeps its runtime directory
(its process group and its logs) under `local_clusters_dir()`, as the
reference's local cloud does.
"""
import os

from skypilot_tpu_torch import envs


def state_dir() -> str:
    """Client-side state root (~/.skytpu or $SKYTPU_STATE_DIR)."""
    d = envs.SKYTPU_STATE_DIR.get() or os.path.expanduser('~/.skytpu')
    os.makedirs(d, exist_ok=True)
    return d


def local_clusters_dir() -> str:
    d = os.path.join(state_dir(), 'local_clusters')
    os.makedirs(d, exist_ok=True)
    return d
