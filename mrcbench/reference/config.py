"""Codec configuration (the port's own copy of the format's constants).

A verbatim copy of the JAX package's `config.py`: the MRC1 format is
defined by these constants, and the PyTorch port keeps its own copy so it
imports nothing of the JAX package. tests/test_torch_primitives.py holds
the two copies equal.

Capability surface: sample rates 32/44.1/48 kHz, mono/stereo, long/short
windows with window switching, full psychoacoustic model (toggleable),
bit reservoir, Huffman entropy coding.
"""
from __future__ import annotations

import dataclasses

SUPPORTED_RATES = (32000, 44100, 48000)

# Block geometry (AAC-style long/short, SURVEY.md §2 R2).
LONG_SIZE = 2048          # long analysis window length
LONG_COEFFS = 1024        # = LONG_SIZE // 2 MDCT coefficients
SHORT_SIZE = 256
SHORT_COEFFS = 128
N_SHORT = 8               # short sub-blocks per frame
HOP = LONG_COEFFS         # frame advance (50% overlap)
# Offset of the first short sub-block inside a 2048 frame (standard
# EIGHT_SHORT placement): shorts cover the central region.
SHORT_OFFSET = (LONG_SIZE - (N_SHORT + 1) * SHORT_COEFFS) // 2  # = 448

# Block types (frame-level window shapes).
LONG, START, SHORT, STOP, STARTSTOP = 0, 1, 2, 3, 4
N_BLOCK_TYPES = 5
BLOCK_TYPE_BITS = 3

# Quantizer (AAC-style nonlinear x^0.75, SURVEY.md §2 R8).
GAIN_BITS = 8
GAIN_MIN, GAIN_MAX = 0, 255
GAIN_BIAS = 128           # step = 2 ** ((gain - GAIN_BIAS) / 4)
QUANT_MAGIC = 0.4054      # rounding offset in the nonlinear quantizer
QMAX = 4095               # quantized magnitude clamp (escape-codable)

# Rate-distortion loop (SURVEY.md §2 R9/R10).
OUTER_MAX = 8             # fixed outer (distortion) iterations
AMP_STEP = 2              # scale-factor amplification per outer iter (quarter steps)
AMP_MAX = 24              # max per-band amplification (6 powers of 2)
GAIN_COARSE_STEP = 8      # coarse sweep step of the two-stage gain search
SF_DELTA_MAX = 60         # scale-factor delta range for the sf codebook

# Bit reservoir (SURVEY.md §2 R11).
RESERVOIR_FRAMES = 6.0    # reservoir cap, in units of mean frame bits
RESERVOIR_MAX_WITHDRAW = 1.0   # max extra withdrawal per frame (x mean bits)
MIN_FRAME_FRAC = 0.3      # floor of per-frame budget (x mean bits)

# Huffman codebooks (SURVEY.md §2 R12).
CB_ZERO, CB_SMALL, CB_MID, CB_ESC = 0, 1, 2, 3
N_CODEBOOKS = 4
CB_BITS = 2
ESC_MAG = 16              # CB_ESC codes magnitude pairs clamped at 16; >=16 escapes
MAX_CODE_LEN = 20         # length-limited canonical Huffman

# Frame syntax sizes (docs/FORMAT.md).
FRAME_LEN_BITS = 20       # per-frame bit-length prefix => parallel decode
MAGIC = 0x4D524331        # "MRC1"


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Frozen, hashable codec config (same fields as the JAX package's)."""

    fs: int = 44100
    channels: int = 2
    bitrate: int = 128000            # total bits/s across channels
    window_switching: bool = True    # False => long windows only
    full_psycho: bool = True         # False => energy/ATH-only thresholds
    reservoir: bool = True
    window: str = "sine"             # "sine" | "kbd"

    def __post_init__(self):
        if self.fs not in SUPPORTED_RATES:
            raise ValueError(f"unsupported sample rate {self.fs}")
        if self.channels not in (1, 2):
            raise ValueError("channels must be 1 or 2")
        if self.window not in ("sine", "kbd"):
            raise ValueError("window must be 'sine' or 'kbd'")
        if not (8000 <= self.bitrate <= 960000):
            raise ValueError("bitrate out of range")

    # -- derived quantities ------------------------------------------------
    @property
    def mean_frame_bits(self) -> float:
        """Mean bits per frame per channel at the target bitrate."""
        return self.bitrate * HOP / self.fs / self.channels

    @property
    def reservoir_cap(self) -> int:
        return int(RESERVOIR_FRAMES * self.mean_frame_bits) if self.reservoir else 0

    def frames_for_samples(self, n: int) -> int:
        """Number of frame slots to encode n samples (with priming+flush)."""
        return frames_for_samples(n)


def frames_for_samples(n: int) -> int:
    """Number of frame slots to encode n samples (with priming+flush).

    Frame f covers samples [f*HOP, f*HOP + LONG_SIZE); sample n-1 is
    fully reconstructed once frame floor((n-1)/HOP)+1 is decoded. Depends
    only on the fixed block geometry, not on any CodecConfig field.
    """
    return max(1, -(-n // HOP) + 1)
