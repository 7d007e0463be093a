"""Host converters of the pigeonhole engine (counterpart of
``hsa_tpu/search/pigeon.py``).

The pigeon engine itself is not ported yet (ROADMAP.md Queue A item 1).
The beam route already needs one of its host helpers, which lives in a
module that imports ``jax.numpy`` at the top, so it is copied here; a test
holds the copy bit-equal to the original.
"""

from __future__ import annotations

import numpy as np


def occ_lists_to_arrays(occs):
    """Adapter: per-read Occurrence lists -> the flat array dict of
    ``pigeon_occ_arrays`` (lists are already deduped + sorted).

    Copy of ``hsa_tpu.search.pigeon.occ_lists_to_arrays``."""
    rid, pos, strand, score, nmm, ngapo, ngape = [], [], [], [], [], [], []
    for j, lst in enumerate(occs):
        for o in lst:
            rid.append(j); pos.append(o.pos); strand.append(o.strand)
            score.append(o.score); nmm.append(o.nmm)
            ngapo.append(o.ngapo); ngape.append(o.ngape)
    return dict(rid=np.asarray(rid, np.int64), pos=np.asarray(pos, np.int64),
                strand=np.asarray(strand, np.int8),
                score=np.asarray(score, np.int32),
                nmm=np.asarray(nmm, np.int32),
                ngapo=np.asarray(ngapo, np.int32),
                ngape=np.asarray(ngape, np.int32))
