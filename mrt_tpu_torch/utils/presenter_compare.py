"""K12 ``resize`` in this tree against other trees, on one card in one call.

    python -m mrt_tpu_torch.utils.presenter_compare build/parent [more trees]

Each tree is a checkout of the repository, such as the parent commit
unpacked under ``build/`` with ``git archive HEAD~ | tar -x -C build/parent``.
This file runs itself (``--measure``) from each tree in a process of its
own, in the order others, this, this, others reversed, with that tree's
package and ``chip_smoke.py`` first on the path: each tree builds its
kernels (so ``-Xptxas -v`` reports its resize kernels' registers and
spills) and runs K12 in its two forms on the path at run E's shapes
(1920x1080 to 3840x2160, on ``chip_smoke.synthetic_presenter_inputs``):
the Lanczos-3 of 3 channels with the clamp and the bilinear of colour,
depth and motion. Per run and tree one JSON line: each form's CUDA-event
ms (50 calls, three times) and its elements that differ from the plain
version; then a summary line with each form's mean over each tree's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 50
FORMS = ("lanczos3_3ch", "bilinear_6ch")


def measure(tree: str) -> None:
    """One JSON line for the tree at ``tree`` (its package imported)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import torch

    import chip_smoke as cs
    from mrt_tpu_torch.kernels import build
    from mrt_tpu_torch.kernels import presenter as PK
    from mrt_tpu_torch.upscale import spatial

    if not torch.cuda.is_available():
        raise SystemExit("presenter_compare measures on a CUDA device; none is available")
    dev = torch.device("cuda:0")
    build.build()
    build.load()
    inp = cs.synthetic_presenter_inputs(torch, dev)
    (h, w), (oh, ow) = inp["depth"].shape, inp["out"]
    line = dict(ptxas={k: v for k, v in build.ptxas.items() if "resize_kernel" in k},
                card=cs.card_line())
    for form, sources, method, clamp in (
            (FORMS[0], (inp["color"],), "lanczos3", True),
            (FORMS[1], (inp["color"], inp["depth"], inp["motion"]), "bilinear", False)):
        tables = (spatial.band_table(h, oh, method, dev), spatial.band_table(w, ow, method, dev))
        k, p = PK.resize(sources, *tables, clamp), PK.resize_plain(sources, *tables, clamp)
        line[form] = dict(
            ms=[cs.cuda_ms(lambda: PK.resize(sources, *tables, clamp), REPS) for _ in range(3)],
            differing=int((k.view(torch.int32) != p.view(torch.int32)).sum()))
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--measure"]:
        measure(os.path.abspath(argv[1]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="other checkouts to compare with this one")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds per tree's run")
    args = ap.parse_args(argv)
    others = [os.path.abspath(t) for t in args.trees]
    order = others + [HERE, HERE] + others[::-1]
    got: dict = {}
    for k, tree in enumerate(order):
        name = "this" if tree == HERE else os.path.relpath(tree, HERE)
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", tree], cwd=tree,
                           capture_output=True, text=True, timeout=args.timeout)
        if p.returncode != 0:
            raise RuntimeError(f"presenter_compare failed in {tree} (rc {p.returncode}):\n"
                               f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        for line in p.stdout.splitlines():
            if line.startswith('{"ptxas"'):
                row = json.loads(line)
                print(json.dumps(dict(order=k, tree=name, **row)), flush=True)
                got.setdefault(name, []).append(row)
    summary = {t: {f: statistics.fmean(x for r in rows for x in r[f]["ms"]) for f in FORMS}
               for t, rows in got.items()}
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
