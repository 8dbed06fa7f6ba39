"""Assembly (_st3_assemble, parallel/ed_batch.py, csrc/edit_distance.cu):
edit-distance jobs a thousand pairs scanned in the window, from
TorchEngine.ed_stats["jobs"]."""


def read(rec):
    return 1e3 * rec.ed_jobs / rec.pairs if rec.pairs else None
