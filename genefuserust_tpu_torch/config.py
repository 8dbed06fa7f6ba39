"""Run-wide settings.

Mirrors the reference's process-wide settings singleton
(reference: src/aux/global_settings.rs:3-29) as an immutable dataclass that
is passed explicitly (and closed over as *static* data by jitted functions —
no mutable global state on the device path).

Hard-coded algorithm constants of the reference are collected here too, with
their source locations, so kernels and host code share one definition.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Settings:
    """Reference defaults: src/aux/global_settings.rs:15-29."""

    unique_requirement: int = 2
    deletion_threshold: int = 50
    output_deletions: bool = False
    output_untranslated: bool = False
    skip_key_dup_threshold: int = 5
    major_gene_key_requirement: int = 40
    minor_gene_key_requirement: int = 20
    mismatch_threshold: int = 10


DEFAULT_SETTINGS = Settings()

# k-mer length (reference: src/core/indexer.rs:35)
KMER = 16

# pass-1 sampling stride in map_read (reference: src/core/indexer.rs:262 `step`)
PASS1_STEP = 2

# mask flags (reference: src/core/indexer.rs:30-33)
MATCH_TOP = 3
MATCH_SECOND = 2
MATCH_NONE = 1
MATCH_UNKNOWN = 0

# segment extraction (reference: src/core/indexer.rs:619-620)
ALLOWED_GAP = 10
THRESHOLD_LEN = 20

# dupe sentinels (reference: src/core/common.rs:31-32)
DUPE_NORMAL_LEVEL = -1
DUPE_HIGH_LEVEL = -2

# paired-end merge minimum overlap (reference: src/core/read.rs:325)
MIN_OVERLAP = 30

# match filtering (reference: src/core/fusion_mapper.rs:325 DIFF_THRESHOLD)
DISTANCE_DIFF_THRESHOLD = 5

# clustering support tolerance (reference: src/core/fusion_result.rs:427 T)
SUPPORT_TOLERANCE = 3

# FASTQ line length cap (reference: src/core/fastq_reader.rs:27 max_take)
FASTQ_LINE_LIMIT = 1000

# fusion CSV line length cap (reference: src/core/fusion.rs:24 max_line)
FUSION_CSV_LINE_LIMIT = 4096
