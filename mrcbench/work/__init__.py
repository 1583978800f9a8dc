"""The work a stage must do, counted from the stage's own inputs and
outputs: the yardstick of the `*_roofline_pct` metrics.

A stage's bytes are its inputs read once and its outputs written once,
at the stage's boundary (constant tables left out); its operations are
the float32 operations its arithmetic needs, counted as the codec
package's `profiling.kernel_bound` counted them for the kernels that ran
the stage when this count was frozen (K5-K8 and K1 for the analysis, K9,
K1 and K10 for the synthesis). Neither depends on how the stage is split
into kernels, so a later fusion, split or rename leaves the count alone.

    rec = STAGES[name].capture(args, kwargs, result)   # inside the call: no sync
    nbytes, ops = STAGES[name].count(rec)              # after the trace
    least_seconds(nbytes, ops)

The rates are the H100 SXM's published ones at its 700 W limit: HBM3 at
3.35e12 B/s; float32 outside the tensor cores at 67e12 FLOP/s, which
counts an FMA as two operations, so 33.5e12 op/s for kernels built with
`--fmad=false`, where each counted operation is an instruction of its own.
"""
from __future__ import annotations

from ..reference import config as C
from ..reference import tables as T
from ..reference.spec import xpsy_np

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2

# f32 ops (profiling.py's constants): xlog2, xexp2; a sample of the
# transient detector and a frame's sub-block ladder
XLOG2_OPS = 29
XEXP2_OPS = 19
TRANSIENT_OPS_PER_SAMPLE = 3
TRANSIENT_OPS_PER_FRAME = 4 * 16 + 15 * 5
# the analysis' FFT inputs a frame: (complex points, FFT size) of the long
# and the short MDCT, the long and the short psycho spectrum
ANALYSIS_FFTS = ((512, 512), (8 * 64, 64), (1024, 1024), (8 * 128, 128))
# the window, fold and pre-twiddle of both MDCT families and the two Hann
# windows, a frame
ANALYSIS_PRE_OPS = 2 * (2048 + 1536 + 512 * 6) + 2 * 2048
MDCT_POST_OPS = 512 * 3 + 512 * 4 + 1024
# the synthesis: dequantize and pre-twiddle a frame, the chain a bin
# beyond QMAX; the long and the short IMDCT's FFT; post-twiddle, unfold,
# window (and a SHORT frame's overlap), the hop add, the int16 rounding
SYNTH_PRE_OPS_PER_FRAME = 1024 * 3 + 2 * 512 * 6
SYNTH_PRE_OPS_OVER_QMAX = XLOG2_OPS + 1 + XEXP2_OPS
SYNTH_FFTS = ((512, 512), (8 * 64, 64))
SYNTH_POST_OPS_LONG = 512 * 3 + 512 * 4 + 1024 + 1536 + 2048
SYNTH_POST_OPS_SHORT = 8 * (64 * 3 + 64 * 4 + 128 + 192 + 256) + 2048
SYNTH_POST_OPS_HOP = 1024
SYNTH_POST_OPS_PCM16 = 1024 * 4


def fft_ops(points: int, n: int) -> int:
    """Radix-2 stages over `points` complex values in FFTs of size n: a
    butterfly of 10 ops for each pair, each stage."""
    return points // 2 * (n.bit_length() - 1) * 10


def least_seconds(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the ops over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _stages(edges) -> int:
    return len(xpsy_np._seg_tables_from_edges(tuple(edges))[0])


def psycho_ops(n_frames: int, n_short: int, fs: int, full: bool) -> int:
    """The psycho model's f32 ops on frames of which n_short are SHORT:
    each frame's own family only (profiling.psycho_ops)."""
    nb_u = T.unified_layout(fs)["nb"]
    total = 0
    for long_block, frames in ((True, n_frames - n_short), (False, n_short)):
        cst = xpsy_np.psy_tables(fs, long_block)
        g = 1 if long_block else C.N_SHORT
        bins, npart, nb = C.LONG_COEFFS, cst["npart"], cst["nb"]
        p2 = 1 << (nb - 1).bit_length()
        part_st = _stages(cst["part_edges"])
        band_st = _stages(cst["band_edges"])
        per = bins * 21 + g
        per += bins * (part_st * (2 if full else 1) + 2 * band_st + 1)
        if full:
            per += bins * (XLOG2_OPS + 1)
            per += g * npart * (2 * npart - 1 + XLOG2_OPS + XEXP2_OPS + 14)
        else:
            per += g * npart
        per += g * npart * 2
        per += g * nb * (npart + 1 + 3 * XLOG2_OPS + XEXP2_OPS + 6)
        per += g * (p2 - 1) + (g - 1)
        per += nb_u * (2 * XLOG2_OPS + XEXP2_OPS + 6)
        total += frames * per
    return total


class Analysis:
    """`_analyze_chunk(audio_ext [R, (s+3)*HOP], cfg)` -> (bt [R, s],
    coeffs [R*s, 1024], allowed [R*s, NB], pe [R, s])."""

    @staticmethod
    def capture(args, kwargs, result):
        audio, cfg = args[0], args[1] if len(args) > 1 else kwargs["cfg"]
        bt = result[0]
        return {"audio_shape": tuple(audio.shape),
                "audio_itemsize": audio.element_size(),
                "out_bytes": sum(_nbytes(t) for t in result),
                "bt": bt, "fs": cfg.fs, "ws": bool(cfg.window_switching),
                "full": bool(cfg.full_psycho)}

    @staticmethod
    def count(rec):
        r, width = rec["audio_shape"]
        s = width // C.HOP - 3
        samples = r * width
        nf = r * s
        conv = 2 * samples if rec["audio_itemsize"] == 2 else 0
        n_short = int((rec["bt"] == C.SHORT).sum())
        ops = conv + (r * (s + 2) * (C.LONG_SIZE * TRANSIENT_OPS_PER_SAMPLE
                                     + TRANSIENT_OPS_PER_FRAME)
                      if rec["ws"] else 0)                        # K5
        ops += conv + nf * ANALYSIS_PRE_OPS                       # K6
        ops += sum(fft_ops(nf * p, n) for p, n in ANALYSIS_FFTS)  # K1 x 4
        ops += nf * MDCT_POST_OPS                                 # K7
        ops += psycho_ops(nf, n_short, rec["fs"], rec["full"])    # K8
        return samples * rec["audio_itemsize"] + rec["out_bytes"], ops


class Synthesis:
    """`_synth_chunk(q [R, s, 1024] int16, e_band [R, s, NB], bt [R, s],
    fs, window, pcm16, prev=None, out=None)` -> (pcm [s*HOP, R], first
    [R, HOP], tail [R, HOP])."""

    @staticmethod
    def capture(args, kwargs, result):
        q, e_band, bt = args[:3]
        pcm16 = args[5] if len(args) > 5 else kwargs["pcm16"]
        prev = args[6] if len(args) > 6 else kwargs.get("prev")
        return {"q": q, "bt": bt, "pcm16": bool(pcm16),
                "in_bytes": (_nbytes(q) + _nbytes(e_band) + _nbytes(bt)
                             + (_nbytes(prev) if prev is not None else 0)),
                "out_bytes": sum(_nbytes(t) for t in result)}

    @staticmethod
    def count(rec):
        bt = rec["bt"]
        nf = bt.numel()
        over = int((rec["q"].int().abs() > C.QMAX).sum())
        n_short = int((bt == C.SHORT).sum())
        ops = nf * SYNTH_PRE_OPS_PER_FRAME + over * SYNTH_PRE_OPS_OVER_QMAX
        ops += sum(fft_ops(nf * p, n) for p, n in SYNTH_FFTS)
        ops += ((nf - n_short) * SYNTH_POST_OPS_LONG
                + n_short * SYNTH_POST_OPS_SHORT
                + nf * (SYNTH_POST_OPS_HOP
                        + (SYNTH_POST_OPS_PCM16 if rec["pcm16"] else 0)))
        return rec["in_bytes"] + rec["out_bytes"], ops


STAGES = {"analysis": Analysis, "synthesis": Synthesis}
