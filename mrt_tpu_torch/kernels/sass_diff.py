"""Compare the SASS of two builds of a kernel source (``csrc/traverse2.cu``
unless named): every kernel of the older source must compile to the same
instructions from the newer one.

Run on a machine with the CUDA toolkit:

    python -m mrt_tpu_torch.kernels.sass_diff OLD.cu [NEW.cu] [--changed NAME ...]

NEW.cu defaults to this checkout's ``csrc/traverse2.cu`` (for another
source, name this checkout's, e.g. ``mrt_tpu_torch/csrc/wavefront.cu``).
Kernels in an anonymous namespace are matched without the hash of the
source's path that their mangled names hold. Branch labels (``.L_x_N``,
numbered over the whole module, so a kernel added before another renumbers
the other's) are renumbered per kernel in the order they appear, and runs of
blanks made one (cuobjdump pads every instruction to the module's widest). A
kernel that
gained template parameters is matched by appending ``false`` for each one
(K2's ``<MASKED, FLOAT_SORT>`` to ``<MASKED, FLOAT_SORT, false>``). Prints one
line per kernel of OLD.cu and exits 1 if any differs or is missing, but for
the kernels whose mangled names hold a ``--changed`` NAME (a change meant
to alter them: their lines say so).

``tap_instructions`` counts the instructions of one K10 tap, and
``slot_instructions`` those of one window slot of K12's strip form, in the
built library (``chip_smoke.py`` prints both beside the kernels' bounds).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

from .build import CSRC, NVCC_FLAGS, _nvcc

_PARAMS = re.compile(r"I((?:Lb[01]E)+)Ev")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")
_LABEL = re.compile(r"\.L_x_\d+")


def _local_labels(lines: list[str]) -> list[str]:
    """``lines`` with each branch label renumbered in the order it first
    appears."""
    seen = {}
    return [_LABEL.sub(lambda m: seen.setdefault(m.group(0), f".L_{len(seen)}"), line)
            for line in lines]


def dump(binary: str) -> dict[str, list[str]]:
    """{mangled kernel name: its SASS lines} of a cubin or a shared library,
    as ``cuobjdump -sass`` prints them (blanks collapsed, labels
    renumbered per kernel, the anonymous namespace's hash dropped)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", binary], check=True, capture_output=True,
                         text=True).stdout
    # an anonymous namespace's mangled name holds a hash of the source's
    # path: the same kernel from two checkouts would not match without this
    txt = _ANON.sub("_GLOBAL__N__", txt)
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None and line.strip():
            # cuobjdump pads each instruction to the module's widest one
            funcs[cur].append(" ".join(line.split()))
    return {name: _local_labels(lines) for name, lines in funcs.items()}


def sass(src: str, workdir: str) -> dict[str, list[str]]:
    """{mangled kernel name: its SASS lines} of ``src`` built with K1-K3's
    flags."""
    nvcc = _nvcc()
    cubin = os.path.join(workdir, os.path.basename(src) + ".cubin")
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", src, "-o", cubin], check=True)
    return dump(cubin)


_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/ (?:@!?U?P[T0-9] )?([A-Z][A-Z0-9_.]*)")


def instructions(lines: list[str]) -> list[str]:
    """The opcodes (with their modifiers) of a kernel's SASS lines, in order."""
    return [m.group(1) for m in map(_OPCODE.search, lines) if m]


def tap_instructions(binary: str) -> dict:
    """Per instantiation of K10 (``atrous_pass_kernel<STEP>``, its 25 taps
    unrolled; each tap's two ``expf`` a ``MUFU.EX2`` each), by its step:
    the instructions issued per tap on the fast path, those from tap 0's
    first ``MUFU.EX2`` to tap 24's first, over 24 (the unrolled body's
    period), the divisions' and ``expf``'s sequences inline (their slow
    paths are calls, not counted); and the kernel's whole instruction
    count."""
    kernel, taps = "atrous_pass_kernel", 25
    out = {}
    for name, lines in dump(binary).items():
        if kernel not in name:
            continue
        step = re.search(kernel + r"ILi(\d+)E", name)
        if step is None:
            raise RuntimeError(f"{name}: no step in the mangled name")
        ops = instructions(lines)
        ex2 = [i for i, op in enumerate(ops) if op.startswith("MUFU.EX2")]
        if len(ex2) != 2 * taps:
            raise RuntimeError(f"{name}: {len(ex2)} MUFU.EX2, expected {2 * taps}")
        out[int(step.group(1))] = dict(
            kernel=name, per_tap=(ex2[-2] - ex2[0]) / (taps - 1), ex2=len(ex2),
            rcp=sum(op.startswith("MUFU.RCP") for op in ops), total=len(ops))
    if not out:
        raise RuntimeError(f"no {kernel} in {binary}")
    return out


def slot_instructions(binary: str) -> dict:
    """Per instantiation of K12's strip form (``resize_strip_kernel<K, C0,
    C1, C2>``, its loop unrolled over the K slots of its window, each slot
    one staged row's width taps and one output row's height taps, K x C
    ``FMUL`` each), by "K{K}C{C}": the instructions of a slot's code, those
    from slot 0's first ``FMUL`` to slot K-1's, over K - 1 (one input row's
    and one output row's; both of the row store's paths, aligned and not,
    of which one runs), its ``FMUL``, ``FADD`` and ``LDS``, and the
    kernel's whole instruction count."""
    kernel = "resize_strip_kernel"
    out = {}
    for name, lines in dump(binary).items():
        m = re.search(kernel + r"ILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        if m is None:
            continue
        k, c = int(m.group(1)), sum(int(m.group(i)) for i in (2, 3, 4))
        ops = instructions(lines)
        fmul = [i for i, op in enumerate(ops) if op.startswith("FMUL")]
        if len(fmul) != 2 * k * c * k:
            raise RuntimeError(f"{name}: {len(fmul)} FMUL, expected {2 * k * c * k}")
        first, last = fmul[0], fmul[2 * k * c * (k - 1)]
        body = ops[first:last]
        out[f"K{k}C{c}"] = dict(
            kernel=name, per_slot=(last - first) / (k - 1),
            **{op.lower(): sum(o.startswith(op) for o in body) / (k - 1)
               for op in ("FMUL", "FADD", "LDS")}, total=len(ops))
    if not out:
        raise RuntimeError(f"no {kernel} in {binary}")
    return out


def twin(name: str, new: dict) -> str | None:
    """``name``'s kernel in ``new``: itself, or with ``false`` appended to
    its boolean template parameters until it is found."""
    for extra in range(4):
        cand = _PARAMS.sub(lambda m: "I" + m.group(1) + "Lb0E" * extra + "Ev", name)
        if cand in new:
            return cand
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    changed = []
    while "--changed" in argv:
        k = argv.index("--changed")
        if k + 1 >= len(argv):
            print(__doc__, file=sys.stderr)
            return 2
        changed.append(argv.pop(k + 1))
        argv.pop(k)
    if not argv or len(argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    new_src = argv[1] if len(argv) > 1 else os.path.join(CSRC, "traverse2.cu")
    with tempfile.TemporaryDirectory() as d:
        old, new = sass(argv[0], d), sass(new_src, d)
    bad = 0
    for name, body in old.items():
        t = twin(name, new)
        same = t is not None and new[t] == body
        meant = any(c in name for c in changed)
        bad += not same and not meant
        print(f"{name} -> {t}: {len(body)} SASS lines, identical: {same}"
              + (" (meant to change)" if meant else ""), flush=True)
        if t is not None and not same:
            k = next((k for k, (a, b) in enumerate(zip(body, new[t])) if a != b),
                     min(len(body), len(new[t])))
            print(f"  first difference at line {k} of {len(body)} / {len(new[t])}:\n"
                  f"  old: {body[k] if k < len(body) else None}\n"
                  f"  new: {new[t][k] if k < len(new[t]) else None}", flush=True)
    print("only in the new source:", sorted(set(new) - {twin(n, new) for n in old}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
