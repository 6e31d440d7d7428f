"""Registers and spills of the port's CUDA kernels, where their spill
loads sit, and which units their instructions use, from the compiler
(needs ``nvcc`` and ``cuobjdump``).

    python -m lsdm_tpu_torch.ptxas_report [sa_fused fp_fused ...]
        [--against OTHER_CSRC]

Compiles each source of ``csrc/`` named (default: the row-MLP kernels K7
and K8 in both modes, the ball query and 3-NN kernels K1 and K2, the
chamfer nearest neighbour K11, FPS, K3, K6's pass 2 in both modes, K9 in
both modes, the attention backward K5 and the select-gather K10 in both
modes)
with the package's
``NVCC_FLAGS`` plus ``-Xptxas -v`` to a cubin under the build directory and
prints, per function (each instance of a template), what ptxas reports:
registers, stack frame, spill stores and spill loads.  For every source it
then counts, per function of the cubin's SASS, its tensor-core products
(``HMMA``: ``mma.sync``; ``HGMMA``: ``wgmma``), its FFMAs, ``ldmatrix``
loads (``LDSM``), SFU operations (``MUFU``), barriers (``BAR``) and
branches (``BRA``).  For the row-MLP sources it splits the SASS at the
targets of its calls (the functions that are not inlined, such as
``rowmlp::dense_tiles<T>``, in address order; the kernel body first): per
part, its FFMA count, its
spill loads (``LDL``) and those of them inside a loop that holds FFMAs
and no inner loop (the FMA loops of the layers).  For every function it
also counts the spill loads inside an innermost loop that holds tensor-
core products (HMMA, HGMMA: the bf16 layers' product loops; the bf16
kernels inline everything, so each template instance is one function) and
inside one that holds FFMAs.
``--against DIR`` also compiles each source from another copy of
``csrc/`` (e.g. a parent tree's ``git archive``) and says, per function of
this tree, whether the other's cubin holds a function with the same SASS,
instruction for instruction (names aside: a kernel that stopped being a
template keeps its code).  The last line is one JSON object with all of it.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from lsdm_tpu_torch import kernels

SOURCES = ("sa_fused", "fp_fused", "sa_fused_bf16", "fp_fused_bf16", "ballquery",
           "chamfer", "fps", "denoise_chain", "denoise_chain_bf16", "denoise_step",
           "denoise_step_bf16", "rank1_attn_bwd", "rank1_attn_bwd_bf16", "sg_fused",
           "sg_fused_bf16")
SASS_SOURCES = ("sa_fused", "fp_fused")
# the opcodes counted per function of the SASS
OPCODES = ("HMMA", "HGMMA", "FFMA", "LDSM", "MUFU", "BAR", "BRA")
_FUNC = re.compile(r"Function properties for (\S+)")
_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")


def ptxas(src: str, cubin: str, csrc: Path = kernels.CSRC) -> list:
    """ptxas's report of each function compiled from ``src`` (in
    ``csrc``)."""
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
           "-cubin", str(Path(csrc) / f"{src}.cu"), "-o", cubin]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    funcs, cur = [], None
    for line in res.stderr.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = {"function": m.group(1)}
            funcs.append(cur)
        elif cur is not None and _PROPS.search(line):
            stack, st, ld = map(int, _PROPS.search(line).groups())
            cur.update(stack=stack, spill_stores=st, spill_loads=ld)
        elif cur is not None and _REGS.search(line):
            cur["registers"] = int(_REGS.search(line).group(1))
    return funcs


def _sass(cubin: str) -> str:
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout


def sass_counts(cubin: str) -> dict:
    """Per function of the cubin's SASS, how many of its instructions have
    each opcode of OPCODES (the mnemonic before its first dot, past any
    predicate)."""
    out, cur = {}, None
    for line in _sass(cubin).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), dict.fromkeys(OPCODES, 0))
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(2)).split()[0].split(".")[0]
            if op in cur:
                cur[op] += 1
    return out


def _innermost_loops(body, ops) -> list:
    """(start, end) of the innermost loops of ``body`` ((address, text)
    pairs; a backward branch closes a loop) that hold an opcode of ``ops``."""
    loops = []
    for a, t in body:
        m = re.search(r"BRA (0x[0-9a-f]+)", t)
        if m and body[0][0] <= int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    return [(s, e) for s, e in loops
            if any(op in t for a, t in body if s <= a <= e for op in ops)
            and not any(s < s2 and e2 < e for s2, e2 in loops)]


def loop_spills(cubin: str) -> dict:
    """Per function of the cubin's SASS: its spill loads (``LDL``) and those
    of them inside an innermost loop that holds tensor-core products (HMMA,
    HGMMA) or FFMAs."""
    out, name, body = {}, None, []

    def close():
        if name is None:
            return
        ldl = [a for a, t in body if re.search(r"\bLDL\b", t)]
        out[name] = {"ldl": len(ldl)}
        for key, ops in (("ldl_in_mma_loops", ("HMMA", "HGMMA")),
                         ("ldl_in_ffma_loops", ("FFMA",))):
            loops = _innermost_loops(body, ops)
            out[name][key] = sum(any(s <= a <= e for s, e in loops) for a in ldl)

    for line in _sass(cubin).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            name, body = m.group(1), []
            continue
        m = _INSTR.search(line)
        if m:
            body.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def sass_bodies(cubin: str) -> dict:
    """Per function of the cubin's SASS, its instructions (address and
    text) as a tuple."""
    out, cur = {}, None
    for line in _sass(cubin).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append(m.groups())
    return {k: tuple(v) for k, v in out.items()}


def sass_parts(cubin: str) -> list:
    """The SASS split at its call targets: per part, its FFMAs, spill loads
    and spill loads inside an innermost loop that holds FFMAs."""
    ins = [(int(a, 16), t) for a, t in _INSTR.findall(_sass(cubin))]
    calls = sorted({int(x, 16) for _, t in ins
                    for x in re.findall(r"CALL\.REL\.NOINC (0x[0-9a-f]+)", t)})
    starts, parts = [0] + calls, []
    for lo, hi in zip(starts, calls + [ins[-1][0] + 16]):
        body = [(a, t) for a, t in ins if lo <= a < hi]
        loops = []
        for a, t in body:  # a backward branch closes a loop
            m = re.search(r"BRA (0x[0-9a-f]+)", t)
            if m and lo <= int(m.group(1), 16) < a:
                loops.append((int(m.group(1), 16), a))
        fma_loops = [(s, e) for s, e in loops
                     if any("FFMA" in t for a, t in body if s <= a <= e)
                     and not any(s < s2 and e2 < e for s2, e2 in loops)]
        ldl = [a for a, t in body if re.search(r"\bLDL\b", t)]
        parts.append({
            "at": hex(lo), "instructions": len(body),
            "ffma": sum("FFMA" in t for _, t in body), "ldl": len(ldl),
            "ldl_in_fma_loops": sum(any(s <= a <= e for s, e in fma_loops)
                                    for a in ldl)})
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=list(SOURCES))
    ap.add_argument("--against", type=Path, default=None,
                    help="another csrc/ whose SASS each function is compared with")
    args = ap.parse_args(argv)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    for src in args.sources:
        cubin = str(kernels.BUILD_DIR / f"{src}.report.cubin")
        funcs = ptxas(src, cubin)
        # one kernel and its out-of-line tiles: the split reads one address space
        parts = sass_parts(cubin) if src in SASS_SOURCES else []
        counts, spills = sass_counts(cubin), loop_spills(cubin)
        for f in funcs:
            ops = ", ".join(f"{n} {op}" for op, n in
                            counts.get(f["function"], {}).items())
            sp = spills.get(f["function"])
            loops = ("" if sp is None else f"; {sp['ldl']} LDL, "
                     f"{sp['ldl_in_mma_loops']} of them in MMA loops, "
                     f"{sp['ldl_in_ffma_loops']} in FFMA loops")
            print(f"{src} {f['function']}: {f.get('registers', '-')} registers, "
                  f"{f['stack']} B stack, {f['spill_stores']} B spill stores, "
                  f"{f['spill_loads']} B spill loads; SASS {ops or 'not found'}"
                  f"{loops}")
        for p in parts:
            print(f"{src} SASS part at {p['at']}: {p['instructions']} "
                  f"instructions, {p['ffma']} FFMA, {p['ldl']} LDL, "
                  f"{p['ldl_in_fma_loops']} of them in FMA loops")
        out[src] = {"ptxas": funcs, "sass": parts, "opcodes": counts,
                    "loop_spills": spills}
        if args.against is not None and (args.against / f"{src}.cu").exists():
            other = str(kernels.BUILD_DIR / f"{src}.against.cubin")
            ptxas(src, other, args.against)
            theirs = set(sass_bodies(other).values())
            same = {f: body in theirs for f, body in sass_bodies(cubin).items()}
            for f, eq in same.items():
                print(f"{src} {f}: SASS {'equal to' if eq else 'differs from'} "
                      f"a function of {args.against}")
            out[src]["same_sass_as_against"] = same
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
