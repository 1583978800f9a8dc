"""Traffic content, drawn from the run's seed.

Copies of the codec package's synthetic clip generators (`bench.make_clip`
and `corpus._synth_corpus`'s clip), each clip seeded by (seed, clip
index), so the same seed gives the same clips. A mix file names its
generator here (`GENERATORS`); a request of `clips_per_request` clips
holds clip (j + r) % distinct at position j of request r.

    clip = GENERATORS[name](fs, seconds, channels, seed, k)   # float32 [n, ch]
    int16 = clips(name, fs, seconds, channels, seed, distinct)

No two calls send the same audio: before each call, every clip buffer
it sends takes back its last note and gets a new one, a short quiet
tone (`NOTE` samples, Hann-shaped, at -20 dBFS, of a pitch of its own)
added at the next place of its walk. The k-th place of a buffer's walk
is (a + k * step) % places, with a, step and the pitch drawn from the
seed and the buffer's place in the ring, and step prime to places, so a
buffer never sends the same audio twice, and the content of any call can
be worked out again (`with_note`). One note changes a few frames'
coefficients, so the streams differ too, and the work a call makes stays
the same.
"""
from __future__ import annotations

import math

import numpy as np


def _rng(seed: int, k: int):
    return np.random.default_rng([int(seed) & (2**64 - 1), int(k)])


def music(fs: int, seconds: float, channels: int, seed: int, k: int):
    """Music-like: an evolving tone stack, a noise floor and transients
    every 0.7 s (bench.make_clip)."""
    rng = _rng(seed, k)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.zeros(n, np.float32)
    for f0, a in [(220, 0.3), (440, 0.2), (1320, 0.12), (3520, 0.07)]:
        x += (a * np.sin(2 * np.pi * f0 * t + 0.1 * np.sin(2 * np.pi * 0.5 * t))
              ).astype(np.float32)
    x += (0.02 * rng.standard_normal(n)).astype(np.float32)
    for pos in range(fs // 2, n - 300, int(0.7 * fs)):
        x[pos:pos + 96] += (0.5 * rng.standard_normal(96)).astype(np.float32)
    x = np.clip(x, -1, 1)
    if channels == 2:
        return np.stack([x, np.roll(x, 11) * 0.9], axis=1)
    return x[:, None]


def tones(fs: int, seconds: float, channels: int, seed: int, k: int):
    """Two tones on a base that steps with the clip index, a noise floor
    and one burst a third of the way in (corpus._synth_corpus's clip k)."""
    rng = _rng(seed, k)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    f0 = 200 + 37.0 * (k % 13)
    x = (0.4 * np.sin(2 * np.pi * f0 * t)
         + 0.15 * np.sin(2 * np.pi * 3.1 * f0 * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    x[n // 3:n // 3 + 80] += (0.5 * rng.standard_normal(80)).astype(np.float32)
    x = np.clip(x, -1, 1)
    return (np.stack([x, np.roll(x, 5) * 0.9], 1) if channels == 2
            else x[:, None])


def to_i16(xf):
    """float32 PCM in [-1, 1] -> int16 (bench.to_i16)."""
    return np.clip(np.round(xf * 32768.0), -32768, 32767).astype(np.int16)


GENERATORS = {"music": music, "tones": tones}


def clips(generator: str, fs: int, seconds: float, channels: int,
          seed: int, distinct: int):
    """The seed's `distinct` clips, int16 [n, channels]."""
    return [to_i16(GENERATORS[generator](fs, seconds, channels, seed, k))
            for k in range(distinct)]


NOTE = 2048                     # samples of a note
NOTE_PEAK = 3277                # int16 steps: -20 dBFS


def walk(seed: int, place, fs: int, clip: np.ndarray):
    """(a, step, note) of the buffer at `place` (a tuple of ints) holding
    this clip: the walk over its note places, and its note, int32
    [NOTE, channels]."""
    places = max(1, len(clip) - NOTE + 1)
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 2, *place])
    a, step = int(rng.integers(places)), int(rng.integers(1, max(2, places)))
    while math.gcd(step, places) != 1:
        step = step % (places - 1) + 1
    pitch = float(rng.uniform(500.0, 4000.0))
    t = np.arange(NOTE) / fs
    tone = NOTE_PEAK * np.hanning(NOTE) * np.sin(2 * np.pi * pitch * t)
    note = np.repeat(np.round(tone).astype(np.int32)[:, None],
                     clip.shape[1], 1)
    return a, step, note


def note_at(clip: np.ndarray, a: int, step: int, k: int) -> slice:
    """The samples that the k-th note of the walk covers."""
    p = (a + k * step) % max(1, len(clip) - NOTE + 1)
    return slice(p, p + NOTE)


def put_note(buf: np.ndarray, clip: np.ndarray, at: slice, note) -> None:
    """buf[at] = clip[at] with the note added, in int16's range."""
    n = len(clip[at])
    buf[at] = np.clip(clip[at].astype(np.int32) + note[:n], -32768, 32767)


def with_note(clip: np.ndarray, a: int, step: int, note, k: int):
    """A copy of the clip with the k-th note of its walk, as the k-th call
    of its buffer sends it."""
    y = clip.copy()
    put_note(y, clip, note_at(clip, a, step, k), note)
    return y


def requests(pool: int, clips_per_request: int, distinct: int):
    """The clip indices of each of `pool` ring slots: slot r holds clip
    (j + r) % distinct at position j."""
    return [[(j + r) % distinct for j in range(clips_per_request)]
            for r in range(pool)]
