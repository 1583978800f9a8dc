"""PyTorch + CUDA port of the MRC1 perceptual audio codec.

A second package beside the JAX reference `mrcaudiocodec_tpu`, with the
same layout: `config`, `tables`, `utils/bits`, `bitstream`, `xmath`,
`xpsy`, `audiofile`, `ops/{dsp,psycho,quantize,reservoir,entropy,rd,
device_pack}`, `ops/kernels/` (the CUDA kernels K1-K13 and their plain
versions: `fft_stages`, `quant_cost`, `record_pack`, `rd_loop`,
`transients`, `analysis_pre`, `mdct_post`, `psycho`, `synth_pre`,
`synth_post`, `pad_rows`, `budget_scan`, `codebook_choice`; sources
under `csrc/`),
`models/{packing,encoder,decoder,codec}`, `native/`, `spec/` (its own
NumPy spec codec), `corpus`, `cli`, `trace` (the encode path's spans and
counters), `profiling` (kernel bounds and device times), `probes/` and
`parallel/{mesh,sharded,launch}`. It imports torch and numpy, never JAX
or the JAX package.

Entry points: `models.codec.encode(x, cfg, device="cuda")` and
`models.codec.decode(data, device="cuda", pcm_dtype="float32")`.

The codec has no learned weights; its state is its constant tables.
`tables_as_numpy(fs)` returns every constant the port uses.
"""
from __future__ import annotations

import numpy as np

from . import config as C


def _tables_from(fs: int, tables, xmath, xpsy) -> dict[str, np.ndarray]:
    """Every constant table, built by the given `tables`/`xmath`/`xpsy`
    modules (this package's, or any with the same functions)."""
    out: dict[str, np.ndarray] = {}
    lay = tables.unified_layout(fs)
    for k, v in lay.items():
        out[f"unified_layout.{k}"] = np.asarray(v)
    for k, v in tables.code_arrays().items():
        out[f"code_arrays.{k}"] = np.asarray(v)
    for which in ("sf", "small", "mid", "esc"):
        mn, mx, fc, fsym, order = tables.decode_table(which)
        out[f"decode_table.{which}.len_range"] = np.asarray([mn, mx])
        out[f"decode_table.{which}.first_code"] = np.asarray(fc)
        out[f"decode_table.{which}.first_sym"] = np.asarray(fsym)
        out[f"decode_table.{which}.order"] = np.asarray(order)
    for kind in ("sine", "kbd"):
        out[f"long_windows.{kind}"] = np.asarray(tables.long_windows(kind))
        out[f"short_window.{kind}"] = np.asarray(tables.short_window(kind))
    for n in (1024, 512, 128, 64):
        tabs = xmath._dif_tables(n)
        out[f"dif_tables.{n}.mask"] = np.stack([t[0] for t in tabs])
        out[f"dif_tables.{n}.tw_re"] = np.stack([t[1] for t in tabs])
        out[f"dif_tables.{n}.tw_im"] = np.stack([t[2] for t in tabs])
    for m in (C.LONG_COEFFS, C.SHORT_COEFFS):
        for k, v in xmath._dct4_tables(m).items():
            out[f"dct4_tables.{m}.{k}"] = np.asarray(v)
    for n in (C.LONG_SIZE, C.SHORT_SIZE):
        cr, ci = xpsy._rfft_tables(n)
        out[f"rfft_tables.{n}.re"] = cr
        out[f"rfft_tables.{n}.im"] = ci
    for long_block in (True, False):
        fam = "long" if long_block else "short"
        for k, v in xpsy.psy_tables(fs, long_block).items():
            out[f"psy_tables.{fam}.{k}"] = np.asarray(v)
    return out


def tables_as_numpy(fs: int) -> dict[str, np.ndarray]:
    """Every constant the port uses at sample rate `fs`, as numpy arrays:
    the unified band layout, code and decode tables, windows, the FFT,
    DCT-IV and real-FFT twiddles, and the long/short psycho tables."""
    from . import tables, xmath, xpsy
    return _tables_from(fs, tables, xmath, xpsy)
