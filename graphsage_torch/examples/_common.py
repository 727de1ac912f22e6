"""What the examples share: their command line and the synthetic Cora."""

from __future__ import annotations

import argparse
import tempfile


def parse_args(argv, steps: int, data_root: bool = False) -> argparse.Namespace:
    """``--device`` (``cuda`` unless ``cpu`` is asked for), ``--steps``
    (default ``steps``) and, where the example loads Cora, ``--data-root``."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=steps)
    if data_root:
        p.add_argument("--data-root", default=None)
    return p.parse_args(argv)


def cora_root(root: str | None = None) -> str:
    """``root``, or a full-shape synthetic Cora (2708 x 1433) written to a
    fresh temporary directory."""
    if root is not None:
        return root
    from graphsage_torch.data.synthetic import synth_cora_files

    root = synth_cora_files(tempfile.mkdtemp(), seed=0)
    print(f"(no --data-root: generated synthetic Cora at {root})")
    return root
