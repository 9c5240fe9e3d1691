"""CMU-MOSEI preprocessing: aligned .csd files -> HF dataset, ported from
``mca_tpu/data/preprocess_cmu.py`` (framework-free: the port keeps its
own copy).

A rebuild of the reference's ``data/process_cmu.py``: reads the
CMU-MultimodalSDK aligned computational-sequence files (h5 containers)
for Labels / COVAREP / FACET / OpenFace / glove_vectors and emits an HF
dataset whose rows are ``{modality: {"data": [T, D] float32}}`` plus a
``Labels`` column — the schema the CMU configs' collators consume.

Streaming generator (one segment at a time), so peak memory is one
sample rather than the reference's ~32 GB full-materialisation.

Usage:
  python -m mca_tpu_torch.data.preprocess_cmu --data-dir <aligned_csd_dir> \
      --out cmu.dataset

``h5py`` and ``datasets`` are imported inside functions only.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterator

import numpy as np

DEFAULT_FILES = {
    "Labels": "All Labels.csd",
    "COVAREP": "COVAREP.csd",
    "FACET": "FACET 4.2.csd",
    "OpenFace": "OpenFace_2.csd",
    "glove_vectors": "glove_vectors.csd",
}


def _open_csd(path: str):
    import h5py

    f = h5py.File(path, "r")
    root = f[list(f.keys())[0]]["data"]
    return f, root


def iter_segments(
    data_dir: str, files: Dict[str, str] = None
) -> Iterator[Dict[str, Dict[str, list]]]:
    files = files or DEFAULT_FILES
    handles = {}
    roots = {}
    try:
        for name, fname in files.items():
            handles[name], roots[name] = _open_csd(
                os.path.join(data_dir, fname)
            )
        for key in roots["Labels"].keys():
            sample = {}
            skip = False
            for name, root in roots.items():
                if key not in root:
                    skip = True
                    break
                feats = np.asarray(
                    root[key]["features"][:], dtype=np.float32
                )
                sample[name] = {"data": feats.tolist()}
            if not skip:
                yield sample
    finally:
        for h in handles.values():
            h.close()


def process(data_dir: str, out_path: str) -> None:
    import datasets as hfds

    ds = hfds.Dataset.from_generator(
        lambda: iter_segments(data_dir)
    )
    ds.save_to_disk(out_path)
    print(f"saved {len(ds)} segments to {out_path}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", default="cmu.dataset")
    a = p.parse_args()
    process(a.data_dir, a.out)


if __name__ == "__main__":
    main()
