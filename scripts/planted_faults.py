#!/usr/bin/env python3
"""Do ``chip_smoke.py``'s bars catch a wrong kernel?  Plants faults and
reads each bar on them, beside the reading of the sound code.

    python3 scripts/planted_faults.py

Flash attention (qwen3-4b's 1 x 32 x 4096 x 128 causal, and the first,
middle and last 512 rows at 32,768, as ``chip_smoke.py`` checks them):
mutated copies of ``csrc/flash_attention.cu`` are built under
``build/planted/`` (the checkout's sources are not touched) and held to
the plain version by the old bar (``allclose`` at 3e-2) and by
``chip_smoke.flash_excess``:

  tile_shift       every causal row sees one 128-key tile too far
  tile_shift_late  the same, only in the query tiles of the second half
  one_key_late     the query tiles of the second half see one key too far
  stale_alpha      the accumulator is not rescaled on a row block's last
                   key tile

Depth-2 parity (``chip_smoke.py``'s ``lm_parity``: 1 x 512, card against
CPU, same params): the card side runs with the attention output (qwen3-4b)
or the SSD output (mamba2-780m) of the last token zeroed, or scaled by
0.95, in every layer, and is read by the logits bar and the hidden-state
bar.  Prints one JSON line per reading.  Needs a CUDA card; exits 2
without one.
"""
from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANT = os.path.join(ROOT, "build", "planted")
FA_SRC = "flash_attention.cu"
LAST_K = "(q_end - 1 + offs) / FA_BK"
# the bf16 wgmma kernel's mask (the line after it tells it from the 3xTF32
# kernels' masks in the same source)
MASK_TAIL = ";\n            s_acc[4 * i + e] = ok"
MASK = "col <= row + offs)" + MASK_TAIL
LATE = "(q0 >= sq / 2 ? {} : 0)"
MUTATIONS = {
    "tile_shift": [
        (LAST_K, "(q_end - 1 + offs + FA_BK) / FA_BK"),
        (MASK, "col <= row + offs + FA_BK)" + MASK_TAIL)],
    "tile_shift_late": [
        (LAST_K, f"(q_end - 1 + offs + {LATE.format('FA_BK')}) / FA_BK"),
        (MASK, f"col <= row + offs + {LATE.format('FA_BK')})" + MASK_TAIL)],
    "one_key_late": [
        (LAST_K, f"(q_end - 1 + offs + {LATE.format(1)}) / FA_BK"),
        (MASK, f"col <= row + offs + {LATE.format(1)})" + MASK_TAIL)],
    "stale_alpha": [("o[i] *= alpha[(i >> 1) & 1];",
                     "o[i] *= kb < last_k ? alpha[(i >> 1) & 1] : 1.f;")],
}


def mutate(text: str, name: str) -> str:
    """``text`` (the flash kernel's source) with ``name``'s mutation; each
    string it replaces must occur exactly once."""
    for old, new in MUTATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} found {text.count(old)} "
                               "times in the source")
        text = text.replace(old, new)
    return text


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def use_sources(build, name: str, csrc: str) -> None:
    """Point the kernel builder at ``csrc`` and its own library folder."""
    from pathlib import Path
    build._CSRC = Path(csrc)
    build.BUILD_DIR = Path(PLANT) / name / "lib"
    build._LIBS.clear()


def planted_csrc(build, name: str) -> str:
    """A copy of the kernel sources with ``name``'s mutation applied."""
    src = os.path.join(PLANT, name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(str(build._CSRC), src)
    path = os.path.join(src, FA_SRC)
    with open(path) as f:
        text = mutate(f.read(), name)
    with open(path, "w") as f:
        f.write(text)
    return src


def flash_readings(torch, cs, q, k, v, rows=None) -> dict:
    """The two bars on one kernel run: every row, or the first, middle and
    last ``rows`` rows against the plain version over the keys each band
    sees (``chip_smoke.flash_bands``)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    out = kfa.flash_attention(q, k, v, causal=True)
    if rows is None:
        pairs = [(out, q, k, v)]
    else:
        pairs = [(out[:, :, a:b], q[:, :, a:b], k[:, :, :e], v[:, :, :e])
                 for a, b, e in cs.flash_bands(q.shape[2], k.shape[2], rows)]
    read = {"max_abs_err": 0.0, "old_bar_pass": True, "err_over_bar": 0.0,
            "atol_needed_at_rtol_2^-7": 0.0}
    for got, qq, kk, vv in pairs:
        want = ref.attention(qq, kk, vv)
        g, w = got.float(), want.float()
        err = (g - w).abs()
        read["max_abs_err"] = max(read["max_abs_err"], err.max().item())
        read["old_bar_pass"] &= bool(torch.allclose(g, w, rtol=3e-2,
                                                    atol=3e-2))
        read["err_over_bar"] = max(read["err_over_bar"], cs.flash_excess(
            got, want, ref.attention(qq, kk, vv.abs())))
        need = (err - 2.0 ** -7 * w.abs()).clamp(min=0).max().item()
        read["atol_needed_at_rtol_2^-7"] = max(
            read["atol_needed_at_rtol_2^-7"], need)
    read["new_bar_pass"] = read["err_over_bar"] <= 1.0
    return read


def flash_faults(torch, cs) -> None:
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    shapes = {}
    gen = torch.Generator(dev).manual_seed(3)
    for s_len in (cs.LM_SEQ, cs.LM_LONG):
        shapes[s_len] = [torch.randn(
            (1, h, s_len, 128), generator=gen, device=dev).bfloat16()
            for h in (32, 8, 8)]
    sound = str(_build._CSRC)
    variants = [("sound", sound)] + [(n, planted_csrc(_build, n))
                                     for n in MUTATIONS]
    for name, csrc in variants:
        use_sources(_build, name, csrc)
        for s_len, (q, k, v) in shapes.items():
            rows = None if s_len == cs.LM_SEQ else cs.LM_ROWS
            emit({"phase": "planted_flash", "variant": name,
                  "shape": f"1 x 32 x {s_len} x 128",
                  "rows": "all" if rows is None else
                  f"first, middle and last {rows}",
                  **flash_readings(torch, cs, q, k, v, rows)})
            torch.cuda.synchronize()
    use_sources(_build, "sound", sound)
    torch.cuda.empty_cache()


def last_row(fn, how: str):
    """``fn`` with its output's last token zeroed or scaled by 0.95 on the
    card (the token axis is 2 for attention, 1 for the SSD)."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw).clone()
        view = out[:, :, -1] if out.dim() == 4 else out[:, -1]
        if how == "zeroed":
            view.zero_()
        else:
            view.mul_(0.95)
        return out
    return wrapped


def parity_faults(torch, cs) -> None:
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.core import basecaller as bc
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    for arch, op in (("qwen3-4b", "flash_attention"),
                     ("mamba2-780m", "ssd_scan")):
        cfg = dataclasses.replace(ARCHS[arch].config(), num_layers=2)
        params, _ = transformer.init(torch.Generator(dev).manual_seed(0),
                                     cfg, device=dev)
        tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (1, cs.LM_PARITY_SEQ))
        cpu_h, cpu_l = cs.last_hidden_and_logits(
            torch, bc.params_to(params, "cpu"), tok, cfg, cpu)
        sound = getattr(ops, op)
        for how in ("sound", "zeroed", "scaled 0.95"):
            if how != "sound":
                setattr(ops, op, last_row(sound, how))
            try:
                card_h, card_l = cs.last_hidden_and_logits(
                    torch, params, tok, cfg, dev)
            finally:
                setattr(ops, op, sound)
            line = cs.parity_line(card_h, cpu_h, card_l, cpu_l)
            line["logits_bar_pass"] = line["max_abs_diff"] <= line["bar"]
            line["hidden_bar_pass"] = line["hidden_over_bar"] <= 1.0
            emit({"phase": "planted_parity", "arch": arch,
                  "fault": how if how == "sound" else
                  f"{op} output of the last token {how}", **line})
        del params
        torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("planted_faults: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels import ref
    ref.full_fp32()
    flash_faults(torch, cs)
    parity_faults(torch, cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
