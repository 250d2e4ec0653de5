#!/usr/bin/env python3
"""The two kernels with no TPU counterpart that rule 2 redesigned, on one
card: the stride-(2, 2, 2) weight gradient (``dw_conv_wgrad_t2``) and the
crop (``crop_resize_kernel``), against a parent checkout and against
variants of this one.

    python3 chip_rule2.py PARENT

PARENT is a checkout directory of the parent commit holding its
``coarse_fine_networks_torch`` (``git archive <commit>
coarse_fine_networks_torch | tar -x -C _scratch/parent``).  In order:

1. ``ptxas``: ``nvcc -cubin -Xptxas -v`` of both trees'
   ``csrc/dw_plain_s2.cu``; every row other than ``plain_t2_wgrad_kernel``'s
   compared (registers, spills, static shared memory; the anonymous
   namespace's per-file hash taken out of the names).
2. ``turns``: parent, change, change, parent, a process each that builds
   its tree's kernels into its own build directory and times
   ``dw_conv_wgrad_t2`` at ``FineNet(t_downsample)``'s four B32 T16 224²
   entries in bf16 and f32 (the call back to back, ``cuda_ms``, and its
   device time, ``queued_ms``; each checked against the plain version) and
   ``crop_resize`` on one clip's 64 frames of 640×480 in a pitched buffer
   (the centre and a train crop to 224²; call and device time, checked
   against the plain version) beside ``F.interpolate`` on the f32 crop.
3. ``variants``: copies of this checkout's package under
   ``_scratch/rule2_variants`` (gitignored), each with one edit of the
   weight gradient, timed at the four entries in bf16 (device time):
   ``loads_only`` (no sums), ``sums_only`` (no loads after the first
   step), ``ahead_2`` (a ring of 7 x and 3 g frames, two steps ahead),
   ``pairs_only`` (K10 plain's per-pair copies, never the whole-pixel
   16-byte mode) and ``groups_32`` (channel groups of at most 32 pairs at
   every width).

Each run prints one JSON line; the card's ``nvidia-smi`` name and power
limit come last.  The timing helpers are this checkout's
``chip_smoke.py``'s.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
VARIANTS_DIR = HERE / "_scratch" / "rule2_variants"
PKG = "coarse_fine_networks_torch"
# FineNet(t_downsample)'s conv2 inputs at B32 T16 224² (chip_smoke.py's
# T2_SHAPES["B32.224"])
T2_ENTRIES = [(32, 16, 112, 112, 54), (32, 8, 56, 56, 108),
              (32, 4, 28, 28, 216), (32, 2, 14, 14, 432)]
# name: (edits of csrc/dw_plain_s2.cu, edits of ops/dw_conv.py)
VARIANTS = {
    "loads_only": ([(
        "    if (wl < WB && tl.w0 + wl < Wo) {  // the thread's column exists",
        "    if (steps < 0) {")], []),
    "sums_only": ([(
        "    __syncthreads();\n    load(s + 1);",
        "    __syncthreads();\n    cp_commit();")], []),
    "ahead_2": ([
        ("constexpr int T2_XSLOTS = 5;", "constexpr int T2_XSLOTS = 7;"),
        ("constexpr int T2_GSLOTS = 2;", "constexpr int T2_GSLOTS = 3;"),
        ("  load(0);\n  for (int s = 0; s < steps; ++s) {",
         "  load(0);\n  load(1);\n  for (int s = 0; s < steps; ++s) {"),
        ("    cp_wait<0>();\n    __syncthreads();\n    load(s + 1);",
         "    cp_wait<1>();\n    __syncthreads();\n    load(s + 2);")],
        [("T2_XSLOTS, T2_GSLOTS = 5, 2", "T2_XSLOTS, T2_GSLOTS = 7, 3")]),
    "pairs_only": ([(
        "  const int whole = p.n_pg == 1 && 2 * PG == C",
        "  const int whole = 0 && p.n_pg == 1 && 2 * PG == C")], []),
    "groups_32": ([], [(
        "    pg_max = p2 if p2 <= T2_WHOLE_PG else DX_PG",
        "    pg_max = DX_PG")]),
}


def _helpers():
    """This checkout's chip_smoke.py (cuda_ms, queued_ms), loaded by path so
    that a tree's own package stays first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(source: Path) -> dict:
    from coarse_fine_networks_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", "/dev/null",
         str(source)], capture_output=True, text=True, check=True)
    rows, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}", "",
                          m.group(1))
            rows[name] = {}
        elif name and "spill stores" in line:
            rows[name]["spills"] = sum(map(int, re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line)))
        elif name and "Used" in line and "registers" in line:
            rows[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                    line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return rows


def time_tree(root: str, label: str, crop: bool, dtypes) -> None:
    """One tree's times (a process of its own, the tree first on
    sys.path): one JSON line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from coarse_fine_networks_torch.data import native
    from coarse_fine_networks_torch.ops import dw_conv
    from coarse_fine_networks_torch.ops import frame_decode as fd

    cs = _helpers()
    torch.backends.cuda.matmul.allow_tf32 = False
    dw_conv.LIBRARY_S2.build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {"tree": label, "t2": [], "crop": {}}
    for dtype in dtypes:
        for b, t, h, w, c in T2_ENTRIES:
            x = torch.randn((b, t, h, w, c), generator=gen,
                            device="cuda").relu().to(dtype)
            g = torch.randn((b, (t - 1) // 2 + 1, (h - 1) // 2 + 1,
                             (w - 1) // 2 + 1, c), generator=gen,
                            device="cuda").to(dtype)

            def call():
                return dw_conv.dw_conv_wgrad(x, g, dw_conv.T2)

            got, ref = call(), dw_conv.dw_conv_wgrad_plain(x, g, dw_conv.T2)
            p = dw_conv.plan_t2(b, t, h, w, c)
            out["t2"].append({
                "x": [b, t, h, w, c], "dtype": str(dtype)[6:],
                "plan": {"r": p.r, "wb": p.wb, "pg": p.pg, "ipb": p.ipb,
                         "rows": p.rows},
                "rel_err": float((got - ref).abs().max())
                / max(1.0, float(ref.abs().max())),
                "ms": cs.cuda_ms(call, 20),
                "device_ms": cs.queued_ms(call, 20)["ms"]})
            del x, g, got, ref
    if crop:
        fd.LIBRARY.build()
        n, hh, ww = 64, 480, 640
        buf = torch.randint(0, 256, (n, hh, fd._pitch(ww, 3)), generator=gen,
                            device="cuda", dtype=torch.uint8)
        raw = buf[:, :, :ww * 3].view(n, hh, ww, 3)
        for name, box_of in (("centre", native.center_box),
                             ("train", native.random_box(224 / 320, 0.3,
                                                         0.6))):
            box = box_of(ww, hh)
            # as the tree's decode_crop_resize passes them: a broadcast
            # array where the wrapper packs the boxes itself, else a list
            boxes = (np.broadcast_to(np.asarray(box, np.int64), (n, 4))
                     if hasattr(fd, "crop_launches") else [box] * n)
            x1, y1, cw, ch = box
            crop_f32 = raw[:, y1:y1 + ch, x1:x1 + cw].permute(
                0, 3, 1, 2).float().contiguous()

            def call():
                return fd.crop_resize(raw, boxes, 224)

            def library():
                return F.interpolate(crop_f32, size=(224, 224),
                                     mode="bilinear", align_corners=False,
                                     antialias=False)

            err = int((call().int() - fd.crop_resize_plain(
                raw, boxes, 224).int()).abs().max())
            out["crop"][name] = {
                "max_abs_err": err, "call_ms": cs.cuda_ms(call, 20),
                "device_ms": cs.queued_ms(call, 50)["ms"],
                "library_ms": cs.cuda_ms(library, 20),
                "library_device_ms": cs.queued_ms(library, 20)["ms"]}
    print(json.dumps(out), flush=True)


def _variant(name: str) -> Path:
    """A copy of this checkout's package with the variant's edits."""
    root = VARIANTS_DIR / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, edits in zip(("csrc/dw_plain_s2.cu", "ops/dw_conv.py"),
                          VARIANTS[name]):
        path = root / PKG / rel
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        path.write_text(text)
    return root


def _build(root: Path, crop: bool) -> None:
    code = (f"import sys; sys.path.insert(0, {str(root)!r}); "
            "from coarse_fine_networks_torch.ops import dw_conv, "
            "frame_decode; dw_conv.LIBRARY_S2.build()"
            + ("; frame_decode.LIBRARY.build()" if crop else ""))
    subprocess.run([sys.executable, "-c", code], check=True)


def _run(root: Path, label: str, crop: bool, dtypes: str) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--time", str(root), label,
         "crop" if crop else "-", dtypes], capture_output=True, text=True)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode or not lines:
        raise SystemExit(f"{label}: rc {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    print(lines[-1], flush=True)
    return json.loads(lines[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_rule2: no CUDA device", file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    if not (parent / PKG).is_dir() or not (HERE / PKG).is_dir():
        print(f"chip_rule2: {PKG} not found in {parent} or beside this "
              f"script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    roots = {"parent": parent, "change": HERE}
    roots.update({name: _variant(name) for name in VARIANTS})
    src = Path(PKG) / "csrc" / "dw_plain_s2.cu"
    with ThreadPoolExecutor(max_workers=8) as pool:
        rows = {k: pool.submit(_ptxas, roots[k] / src)
                for k in ("parent", "change")}
        builds = [pool.submit(_build, r, k in ("parent", "change"))
                  for k, r in roots.items()]
        for f in builds:
            f.result()
        rows = {k: f.result() for k, f in rows.items()}
    others = [n for n in rows["change"] if "plain_t2_wgrad_kernel" not in n]
    differ = {n: (rows["parent"].get(n), rows["change"][n]) for n in others
              if rows["parent"].get(n) != rows["change"][n]}
    print(json.dumps({"ptxas": "dw_plain_s2.cu", "rows_compared":
                      len(others), "differ": differ,
                      "t2_wgrad_change": {n: v for n, v in
                                          rows["change"].items()
                                          if "plain_t2_wgrad_kernel" in n}}),
          flush=True)
    for label in ("parent", "change", "change", "parent"):
        _run(roots[label], label, True, "bfloat16,float32")
    for name in VARIANTS:
        _run(roots[name], name, False, "bfloat16")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--time":
        import torch

        time_tree(sys.argv[2], sys.argv[3], sys.argv[4] == "crop",
                  [getattr(torch, d) for d in sys.argv[5].split(",")])
    else:
        sys.exit(main())
