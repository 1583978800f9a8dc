"""A cell's load: its clips and requests from the seed, the codec entry
point its mix drives, the reference's answer, and the comparison that
decides `correct`.

Entry points (a mix names one in `"entry"`):
    encode        models.codec.encode(clip, cfg, device)        -> [stream]
    encode_batch  corpus.encode_batch(clips, cfg, devices=[dev]) -> streams
    decode        models.codec.decode(stream, device, pcm_dtype) -> [pcm]
                  (its streams are made in set-up by the codec's encoder)

The clips come from the mix's `clips_seed`, the same in every run, and
the notes from the run's seed.
Calls are numbered from 0, the warm-up's first, and call c sends ring
slot c % requests. An encode slot is a set of clip buffers of its own;
before each call every buffer of the slot moves its note on (`gen.walk`),
so no two calls send the same audio, and a buffer's content at any call
can be worked out again. A decode slot is a stream of its own, made in
set-up from its clip with the first note of its walk, so the ring's
streams all differ.

The outputs of `keep` calls of the window are compared with the
reference's for their clips (for a batch, `keep_clips` of its clips, one
from each equal share of it): stream bytes exactly, and for the decode
the int16 PCM exactly. The reference works its streams out from the same
clips; it takes nothing the codec made.
"""
from __future__ import annotations

import numpy as np

from . import gen
from .reference import runner
from .reference.config import CodecConfig as RefConfig

CODEC_KEYS = ("fs", "channels", "bitrate", "window_switching", "full_psycho",
              "reservoir", "window")


class Load:
    """The seed's clips and calls for one cell. `overrides`
    ({"config": {...}, "traffic": {...}}) shrinks a cell for the CPU
    tests; the command never passes it."""

    def __init__(self, cell: dict, seed: int, overrides: dict | None = None):
        over = overrides or {}
        self.conf = dict(cell["config"], **over.get("config", {}))
        self.mix = dict(cell["traffic"], **over.get("traffic", {}))
        self.entry = self.mix["entry"]
        if self.entry not in ("encode", "encode_batch", "decode"):
            raise ValueError(f"no entry point {self.entry!r}")
        if self.entry != "encode_batch" and self.conf["clips_per_request"] != 1:
            raise ValueError(f"{self.entry} takes one clip a request")
        if self.mix["pcm"] != "int16":
            raise ValueError("the clips are int16 PCM, as a 16-bit WAV gives")
        self.seed = seed
        c, m = self.conf, self.mix
        # every run sends the same clips (the mix's `clips_seed`): the
        # run's seed moves their notes, and leaves the work as it is
        self.base = gen.clips(m["generator"], c["fs"], c["clip_seconds"],
                              c["channels"], m["clips_seed"],
                              m["distinct_clips"])
        self.slots = gen.requests(m["requests"], c["clips_per_request"],
                                  m["distinct_clips"])
        self.walks = [[gen.walk(seed, (q, j), c["fs"], self.base[i])
                       for j, i in enumerate(s)]
                      for q, s in enumerate(self.slots)]
        self.audio_s = c["clips_per_request"] * len(self.base[0]) / c["fs"]
        self.codec_kw = {k: c[k] for k in CODEC_KEYS}
        n, k = c["clips_per_request"], min(m.get("keep_clips", 1),
                                           c["clips_per_request"])
        rng = np.random.default_rng([seed & (2**64 - 1), 3])
        self.checked = sorted({i * n // k + int(rng.integers(
            max(1, (i + 1) * n // k - i * n // k))) for i in range(k)})

    def key(self, c: int, j: int):
        """(slot, clip, note) of clip j of call c."""
        k = 0 if self.entry == "decode" else c // len(self.slots)
        return c % len(self.slots), j, k

    def content(self, c: int, j: int) -> np.ndarray:
        """Clip j of call c, as it was sent (for the decode, as its stream
        was made)."""
        q, j, k = self.key(c, j)
        return gen.with_note(self.base[self.slots[q][j]], *self.walks[q][j],
                             k)

    # -- the program's side -------------------------------------------------

    def setup(self, device):
        """Import the codec, build its kernels where they are stale, and
        make the ring that the calls send (the decode's streams, by the
        codec's own encoder)."""
        from mrcaudiocodec_tpu_torch import corpus
        from mrcaudiocodec_tpu_torch.config import CodecConfig
        from mrcaudiocodec_tpu_torch.models import codec
        if str(device).startswith("cuda"):
            # the kernels this path launches, built together where stale
            from mrcaudiocodec_tpu_torch.ops.kernels import build
            build.build(build.MAIN)
        self.device = device
        self.cfg = CodecConfig(**self.codec_kw)
        self.codec, self.corpus = codec, corpus
        self.streams = None
        if self.entry == "decode":
            self.streams = [codec.encode(self.content(q, 0), self.cfg,
                                         device=device)
                            for q in range(len(self.slots))]
            return
        self.ring = [[self.base[i].copy() for i in s] for s in self.slots]

    def next_input(self, c: int):
        """Call c's input, each encode buffer with its note moved on."""
        q, _, k = self.key(c, 0)
        if self.entry == "decode":
            return self.streams[q]
        for buf, i, (a, step, note) in zip(self.ring[q], self.slots[q],
                                           self.walks[q]):
            clip = self.base[i]
            if k:
                last = gen.note_at(clip, a, step, k - 1)
                buf[last] = clip[last]
            gen.put_note(buf, clip, gen.note_at(clip, a, step, k), note)
        return self.ring[q][0] if self.entry == "encode" else self.ring[q]

    def call(self, inp) -> list:
        """One request -> its outputs, one a clip, in host memory."""
        if self.entry == "encode":
            return [self.codec.encode(inp, self.cfg, device=self.device)]
        if self.entry == "encode_batch":
            return self.corpus.encode_batch(inp, self.cfg,
                                            devices=[self.device])
        pcm, _ = self.codec.decode(inp, device=self.device,
                                   pcm_dtype=self.mix["pcm_out"])
        return [pcm]

    # -- the reference's side -----------------------------------------------

    def expected(self, calls, workers=None, lower=False) -> dict:
        """{(slot, clip, note): (stream, int16 PCM or None)}: the
        reference's answer for each checked clip of these calls; lower:
        the control's."""
        keys, clips = [], []
        for c in calls:
            for j in self.checked:
                if self.key(c, j) not in keys:
                    keys.append(self.key(c, j))
                    clips.append(self.content(c, j))
        streams = runner.encode_clips(clips, RefConfig(**self.codec_kw),
                                      workers, lower)
        pcm = (runner.decode_streams(streams, workers, lower)
               if self.entry == "decode" else [None] * len(streams))
        return dict(zip(keys, zip(streams, pcm)))

    def compare(self, kept, want: dict, failed: int, streams=None) -> dict:
        """kept: [(call, outputs)] of the window; want: expected() of
        those calls -> {name: (number, limit)}, each number at most its
        limit when the run is correct. streams: the decode's set-up
        streams, one a ring slot."""
        checks = {"failed": (failed, 0)}
        wrong = 0
        if self.entry == "decode":
            bad, worst, seen = 0, 0, set()
            for c, outs in kept:
                key = self.key(c, 0)
                if key not in seen:
                    seen.add(key)
                    wrong += streams[key[0]] != want[key][0]
                got, ref = outs[0], want[key][1]
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    bad, worst = bad + 1, 65535
                    continue
                d = int(np.abs(got.astype(np.int32) - ref).max(initial=0))
                bad += d > 0
                worst = max(worst, d)
            checks["wrong_streams"] = (wrong, 0)
            checks["wrong_pcm"] = (bad, 0)
            checks["pcm_diff_max"] = (worst, 0)
        else:
            n = self.conf["clips_per_request"]
            for c, outs in kept:
                wrong += abs(len(outs) - n)
                wrong += sum(j >= len(outs) or outs[j] != want[
                    self.key(c, j)][0] for j in self.checked)
            checks["wrong_streams"] = (wrong, 0)
        return checks
