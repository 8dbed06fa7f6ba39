"""On-disk panel index cache.

The reference rebuilds the k-mer index on every run (indexer.rs:122); this
cache (SURVEY §5 "checkpoint/resume" improvement) persists the built index
keyed by (reference identity, fusion CSV content, dup-threshold setting).
Reference identity uses (path, size, mtime) — the standard staleness proxy.
Pure optimization: cached and fresh builds are bit-identical.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger("genefuse")


def _key(ref_file: str, fusion_file: str, dup_threshold: int) -> str:
    h = hashlib.sha256()
    st = os.stat(ref_file)
    h.update(f"{os.path.abspath(ref_file)}|{st.st_size}|{st.st_mtime_ns}".encode())
    with open(fusion_file, "rb") as f:
        h.update(f.read())
    h.update(str(dup_threshold).encode())
    return h.hexdigest()[:24]


_ARRAYS = (
    "se_kmer", "se_contig", "se_pos", "uniq_keys", "group_start", "group_count"
)


def load(cache_dir: str, ref_file: str, fusion_file: str, indexer) -> bool:
    """Populate `indexer` from cache; True on hit. Numeric arrays are
    memory-mapped (lazy — the device path barely touches them)."""
    try:
        base = os.path.join(
            cache_dir,
            f"index_{_key(ref_file, fusion_file, indexer.settings.skip_key_dup_threshold)}",
        )
        if not os.path.exists(base + "_meta.npz"):
            return False
        for name in _ARRAYS:
            setattr(indexer, name, np.load(f"{base}_{name}.npy", mmap_mode="r"))
        z = np.load(base + "_meta.npz", allow_pickle=True)
        indexer.fusion_seq = list(z["fusion_seq"])
        indexer.unique_pos = int(z["unique_pos"])
        indexer.dupe_pos = int(z["dupe_pos"])
        log.info("index cache hit: %s", base)
        return True
    except Exception as e:
        log.warning("index cache load failed (%s); rebuilding", e)
        return False


def save(cache_dir: str, ref_file: str, fusion_file: str, indexer) -> None:
    try:
        os.makedirs(cache_dir, exist_ok=True)
        base = os.path.join(
            cache_dir,
            f"index_{_key(ref_file, fusion_file, indexer.settings.skip_key_dup_threshold)}",
        )
        for name in _ARRAYS:
            np.save(f"{base}_{name}.npy", getattr(indexer, name))
        np.savez(
            base + "_meta.npz",
            fusion_seq=np.array(indexer.fusion_seq, dtype=object),
            unique_pos=indexer.unique_pos,
            dupe_pos=indexer.dupe_pos,
        )
        log.info("index cached: %s", base)
    except Exception as e:  # cache failures must never fail the run
        log.warning("index cache save failed: %s", e)
