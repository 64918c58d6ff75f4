"""Flow visualization CLI of the PyTorch port (reference flowviz.py —
batch .flo -> PNG).

  python -m dexiraft_tpu_torch viz --input flows/ --output viz/
  python -m dexiraft_tpu_torch viz --input a.flo b.flo --rad_max 40

Counterpart of ``dexiraft_tpu/viz_cli.py``; the PNGs are written by the
port's own codec (data/png.py), not imageio.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
from glob import glob


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dexiraft-torch-viz")
    p.add_argument("--input", nargs="+", required=True,
                   help=".flo files or directories to scan recursively")
    p.add_argument("--output", default=None,
                   help="output dir (default: next to each input)")
    p.add_argument("--rad_max", type=float, default=None,
                   help="fixed magnitude normalization (consistent colors "
                        "across a sequence); default: per-frame max")
    return p


def main(argv=None) -> None:
    from dexiraft_tpu_torch.data.flow_io import read_flo
    from dexiraft_tpu_torch.data.png import write_png
    from dexiraft_tpu_torch.eval.flow_viz import flow_to_image

    args = build_parser().parse_args(argv)
    files = []  # (path, output-relative name)
    for item in args.input:
        if osp.isdir(item):
            # keep subdirectory structure under --output: Sintel scenes
            # all name their frames frame_0001.flo etc., so flattening to
            # basenames would silently overwrite
            for f in sorted(glob(osp.join(item, "**", "*.flo"),
                                 recursive=True)):
                files.append((f, osp.relpath(f, item)))
        else:
            files.append((item, osp.basename(item)))
    if not files:
        raise SystemExit("no .flo files found")

    for f, rel in files:
        img = flow_to_image(read_flo(f), rad_max=args.rad_max)
        if args.output:
            out = osp.join(args.output, osp.splitext(rel)[0] + ".png")
            os.makedirs(osp.dirname(out) or ".", exist_ok=True)
        else:
            out = osp.splitext(f)[0] + ".png"
        write_png(out, img)
        print(f"{f} -> {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
