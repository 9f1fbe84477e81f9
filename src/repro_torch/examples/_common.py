"""The examples' shared ``--device`` flag."""

from __future__ import annotations

import argparse
import sys


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where to run (default: the CUDA device)")
    return ap


def device(name: str, requested):
    """The run's device: the card unless ``requested`` names another;
    exits naming "no CUDA device" where there is none."""
    from repro_torch.kernels.ops import resolve_device

    try:
        return resolve_device(requested)
    except RuntimeError as e:
        sys.exit(f"repro_torch.examples.{name}: {e}")
