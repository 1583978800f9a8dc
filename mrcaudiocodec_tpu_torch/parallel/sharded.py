"""Sharded encode and decode: clips over "data" x frames over "seq".

Port of mrcaudiocodec_tpu/parallel/sharded.py:

* Data axis: each data index owns a contiguous block of whole clips (its
  channels' rows) and needs nothing from the others.
* Frame axis: each seq shard owns a contiguous run of frames of every row
  of its block. Its audio takes a halo of 2 hops from the shard before it
  and 1 hop from the shard after it (zeros at the clip's ends), so it
  covers frames [f0-1, f0+s+1): exactly the input of the encoder's own
  chunk analysis (`encoder._analyze_chunk`), which sees the true
  neighbour frames and so gives the edge frames' block types. This wider
  halo replaces the JAX body's exchange of boundary transient flags.
* Bit reservoir: each shard sums its rows' masked PE (int64, one
  all-reduce), scans its frames' clamped-add maps and shares its total
  map (one all-gather of 3 ints a row); the maps of the shards before it
  give its entering level (ops/reservoir.py). Sequential semantics,
  parallel execution.
* Records: each shard decides its frames (K2) and packs them in stream
  order (K3); a clip's stream is its header and the join, in seq order,
  of its shards' body slices, gathered to the seq group's first shard.
* Decode: each shard synthesizes its frames (decoder._synth_chunk: K9,
  K1, K10) and takes one halo, the tail (last second half) of the shard
  before it, which its first hop adds to its frame 0's first half.

Every global quantity comes through an exchange object: `LocalShards`
runs every shard of the grid in turn in one process on one device (the
tests, and the card with a single GPU); `GroupShards` runs this process's
shard and exchanges over the grid's process groups (halos by
`batch_isend_irecv`, the PE sums by an int64 `all_reduce`, the maps by
`all_gather`, the bodies by a `gather` to the seq group's first rank).
Both give streams byte-identical to
`models.codec.encode` and PCM bitwise equal to `models.codec.decode`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import config as C
from ..bitstream import read_header
from ..config import CodecConfig
from ..models import decoder, encoder
from ..ops import device_pack, reservoir
from .mesh import Grid, data_block, seq_block


# ---------------------------------------------------------------------------
# Exchanges. Each method takes one value per local shard (`local`, in rank
# order) and returns one per local shard.
# ---------------------------------------------------------------------------


class LocalShards:
    """Every shard of `grid` in this process, in turn, on one device."""

    def __init__(self, grid: Grid, device="cuda"):
        self.grid = grid
        self.device = encoder.device_for(device)
        self.local = [grid.coords(r) for r in range(grid.size)]

    def _groups(self, parts):
        """Parts in rank order -> one list per seq group, in seq order."""
        n = self.grid.n_seq
        return [list(parts[i:i + n]) for i in range(0, len(parts), n)]

    def halo(self, to_next, to_prev=None):
        """Each shard's `to_next` goes to the next shard of its seq group,
        its `to_prev` to the one before -> (from_prev, from_next), zeros at
        the group's ends (from_next None if to_prev is)."""
        from_prev, from_next = [], []
        for g in self._groups(to_next):
            from_prev += [torch.zeros_like(g[0])] + g[:-1]
        if to_prev is None:
            return from_prev, None
        for g in self._groups(to_prev):
            from_next += g[1:] + [torch.zeros_like(g[-1])]
        return from_prev, from_next

    def seq_sum(self, parts):
        """The sum over each seq group of its shards' int64 parts."""
        out = []
        for g in self._groups(parts):
            total = g[0]
            for t in g[1:]:
                total = total + t
            out += [total] * len(g)
        return out

    def seq_all_gather(self, parts):
        """[S, ...]: each seq group's parts stacked in seq order."""
        out = []
        for g in self._groups(parts):
            out += [torch.stack(g)] * len(g)
        return out

    def seq_gather_bytes(self, blobs):
        """At each seq group's first shard, the group's blobs in seq order;
        None at the others."""
        out = []
        for g in self._groups(blobs):
            out += [g] + [None] * (len(g) - 1)
        return out

    def world_gather(self, parts):
        """Every shard's part, in rank order (equal shapes)."""
        return [list(parts)] * len(parts)


class GroupShards:
    """This process's shard of `grid` (a grid made with a process group);
    exchanges over its seq group, and the world for `world_gather`.

    The collectives run on the compute device under NCCL. Under gloo
    they run on the host, so tensors on the card are staged through host
    memory (`staged`)."""

    def __init__(self, grid: Grid, device="cuda"):
        self.grid = grid
        self.device = encoder.device_for(device)
        self.rank = dist.get_rank()
        self.local = [grid.coords(self.rank)]
        self.group = grid.seq_group()
        nccl = dist.get_backend(self.group) == "nccl"
        self.comm = self.device if nccl else torch.device("cpu")
        self.staged = self.comm != self.device

    def _peer(self, s: int) -> int:
        """The global rank of seq index s of this rank's group."""
        return dist.get_global_rank(self.group, s)

    def _out(self, t):
        return t.to(self.comm).contiguous()

    def halo(self, to_next, to_prev=None):
        s, n = self.local[0][1], self.grid.n_seq
        ops, got = [], []
        for send, step in ((to_next, 1), (to_prev, -1)):
            if send is None:
                got.append(None)
                continue
            t = self._out(send[0])
            recv = torch.zeros_like(t)        # zeros at the group's ends
            if 0 <= s + step < n:
                ops.append(dist.P2POp(dist.isend, t, self._peer(s + step),
                                      self.group))
            if 0 <= s - step < n:
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self._peer(s - step), self.group))
            got.append(recv)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        from_prev, from_next = (None if t is None else [t.to(self.device)]
                                for t in got)
        return from_prev, from_next

    def seq_sum(self, parts):
        t = self._out(parts[0]).clone()
        dist.all_reduce(t, group=self.group)
        return [t.to(self.device)]

    def _all_gather(self, t, group):
        t = self._out(t)
        out = [torch.empty_like(t)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, t, group=group)
        return out

    def seq_all_gather(self, parts):
        return [torch.stack(self._all_gather(parts[0], self.group)).to(
            self.device)]

    def seq_gather_bytes(self, blobs):
        # every rank learns the lengths, then the blobs, padded to the
        # longest, go to the group's first rank only
        n = torch.tensor([len(blobs[0])], dtype=torch.int64)
        lens = [int(x) for x in self._all_gather(n, self.group)]
        buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
        if lens[self.local[0][1]]:
            buf[:len(blobs[0])] = torch.frombuffer(bytearray(blobs[0]),
                                                   dtype=torch.uint8)
        first = self.local[0][1] == 0
        buf = self._out(buf)
        got = [torch.empty_like(buf) for _ in lens] if first else None
        dist.gather(buf, got, group=self.group, group_dst=0)
        if not first:
            return [None]
        return [[g[:k].cpu().numpy().tobytes() for g, k in zip(got, lens)]]

    def world_gather(self, parts):
        return [[t.to(self.device) for t in self._all_gather(parts[0],
                                                             None)]]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def pad_rows(clips: list[np.ndarray], n_seq: int = 1):
    """Clips [n_i, nch] (one dtype, int16 or float32) -> (rows [clips *
    nch, F * HOP], nf_row [clips * nch], n_samples [clips]): each channel
    one row in the shard layout, the clip's samples from the row's start
    (frame f spans row[(f-1)*HOP : (f+1)*HOP]), zeros behind. F is the
    longest clip's frame count rounded up to n_seq shards of at least 2
    frames."""
    nch = clips[0].shape[1]
    n_samples = [x.shape[0] for x in clips]
    nf_list = [C.frames_for_samples(n) for n in n_samples]
    f = max(max(nf_list), 2 * n_seq)
    f = -(-f // n_seq) * n_seq
    rows = np.zeros((len(clips) * nch, f * C.HOP), clips[0].dtype)
    for i, x in enumerate(clips):
        rows[i * nch:(i + 1) * nch, :x.shape[0]] = x.T
    return rows, np.repeat(nf_list, nch), n_samples


class _Shard:
    """One shard's place: data index d (clips `clips`, rows `rows`), seq
    index s (frames `frames`), and its per-row true frame counts."""

    def __init__(self, grid, d, s, n_clips, nch, n_frames, nf_row):
        self.d, self.s = d, s
        self.clips = data_block(grid, d, n_clips)
        self.rows = slice(self.clips.start * nch, self.clips.stop * nch)
        self.frames = seq_block(grid, s, n_frames)
        self.f0 = self.frames.start
        self.n = self.frames.stop - self.frames.start
        self.nf_row = nf_row[self.rows]


def _budgets(shards, pes, cfg: CodecConfig, exchange):
    """Each shard's PE [R, s] -> its budgets [R, s], the reservoir chain of
    every row run across the seq shards."""
    mean_bits = int(cfg.mean_frame_bits)
    if not cfg.reservoir:
        return [torch.full(pe.shape, mean_bits, dtype=torch.int64,
                           device=pe.device) for pe in pes]
    pe_q = [reservoir.masked_pe(pe, sh.nf_row, sh.f0)
            for sh, pe in zip(shards, pes)]
    totals = exchange.seq_sum([p.sum(-1) for p in pe_q])
    desired = [reservoir.desired_bits(
        p, mean_bits, reservoir.mean_pe_from_sum(
            t, torch.as_tensor(sh.nf_row, device=p.device)))
        for sh, p, t in zip(shards, pe_q, totals)]
    prefix = [reservoir.local_maps(de, mean_bits, cfg.reservoir_cap)
              for de in desired]
    maps = exchange.seq_all_gather([torch.stack([m[..., -1] for m in p])
                                    for p in prefix])          # [S, 3, R]
    return [reservoir.budgets_from_prefix(
        de, p, reservoir.carry_in(tuple(g[:, k] for k in range(3)), sh.s),
        mean_bits)
        for sh, de, p, g in zip(shards, desired, prefix, maps)]


def sharded_encode(rows: np.ndarray, nf_row, cfg: CodecConfig, grid: Grid,
                   exchange, pack: bool = True, n_samples=None):
    """Encode rows in the shard layout (`pad_rows`; int16 or float32, clip
    j holding rows j*nch .. j*nch + nch - 1) with each row's true frame
    count nf_row, over `grid` through `exchange`, on the exchange's
    device. The counterpart of JAX `sharded_encode_step` (per_row_nf).

    pack=True: -> each clip's MRC1 stream (header with n_samples[j], then
    the join of its shards' bodies) where this process holds it (the
    first seq shard of the clip's data index), None elsewhere.
    pack=False: -> {q int16, amp int8, gain int16, bt int8, cb int8} host
    arrays [R, F, ...] of the decisions, zero where this process ran no
    shard."""
    if exchange.grid != grid:
        raise ValueError("the exchange was made for another grid")
    if pack and n_samples is None:
        raise ValueError("pack=True needs each clip's n_samples")
    nch = cfg.channels
    n_rows, width = rows.shape
    n_frames = width // C.HOP
    if width % C.HOP or n_rows % nch:
        raise ValueError(f"rows {rows.shape} are not whole hops of whole "
                         f"{nch}-channel clips")
    if n_frames % grid.n_seq or n_frames // grid.n_seq < 2:
        raise ValueError(f"{n_frames} frames do not split into {grid.n_seq} "
                         f"seq shards of at least 2 frames")
    n_clips = n_rows // nch
    pad = -n_clips % grid.n_data            # silent clips fill "data"
    nf_row = np.concatenate([np.asarray(nf_row, np.int64),
                             np.full(pad * nch, n_frames, np.int64)])
    if pad:
        rows = np.concatenate([rows, np.zeros((pad * nch, width),
                                              rows.dtype)])
    dev = exchange.device
    shards = [_Shard(grid, d, s, n_clips + pad, nch, n_frames, nf_row)
              for d, s in exchange.local]

    # this shard's hops, and the halos: 2 hops before, 1 after
    own = [torch.from_numpy(np.ascontiguousarray(
        rows[sh.rows, sh.f0 * C.HOP:(sh.f0 + sh.n) * C.HOP])).to(dev)
        for sh in shards]
    prev, nxt = exchange.halo([o[:, -2 * C.HOP:] for o in own],
                              [o[:, :C.HOP] for o in own])
    ext = [torch.cat(t, dim=1) for t in zip(prev, own, nxt)]
    del own, prev, nxt

    # analysis in the encoder's chunks; the shard's edges take the halos
    spans = [encoder.chunk_spans(sh.n, sh.rows.stop - sh.rows.start)
             for sh in shards]
    chunks = [[encoder._analyze_chunk(e[:, c0 * C.HOP:(c0 + cs + 3) * C.HOP],
                                      cfg) for c0, cs in sp]
              for e, sp in zip(ext, spans)]
    del ext
    budgets = _budgets(shards, [torch.cat([c[3] for c in ch], dim=1)
                                for ch in chunks], cfg, exchange)

    if not pack:
        out = {}
        for sh, ch, sp, b in zip(shards, chunks, spans, budgets):
            real = max(0, min(sh.rows.stop, n_clips * nch) - sh.rows.start)
            for c, (c0, cs) in zip(ch, sp):
                dec = encoder.decide_chunk(c, b[:, c0:c0 + cs], cfg)
                for k, t in zip(("q", "amp", "gain", "bt", "cb"), dec):
                    t = t.cpu().numpy()
                    a = out.setdefault(k, np.zeros(
                        (n_clips * nch, n_frames) + t.shape[2:], t.dtype))
                    a[sh.rows.start:sh.rows.start + real,
                      sh.f0 + c0:sh.f0 + c0 + cs] = t[:real]
        return out

    cap = device_pack.pack_cap_bytes(cfg)
    blobs = []
    for sh, ch, sp, b in zip(shards, chunks, spans, budgets):
        n_loc = sh.clips.stop - sh.clips.start
        pieces = [[] for _ in range(n_loc)]
        for c, (c0, cs) in zip(ch, sp):
            order, counts = encoder.stream_order(
                sh.nf_row, nch, sh.f0 + c0, cs, sh.rows.stop - sh.rows.start)
            packed = encoder.pack_chunk(
                encoder.decide_chunk(c, b[:, c0:c0 + cs], cfg),
                torch.from_numpy(order).to(dev), cfg, cap)
            for j, piece in enumerate(encoder.clip_slices(
                    *encoder.download_body(packed), counts)):
                pieces[j].append(piece)
        slices = [b"".join(p) for p in pieces]
        # one blob a shard: its clips' slice lengths (int64), then the slices
        blobs.append(np.asarray([len(x) for x in slices], np.int64).tobytes()
                     + b"".join(slices))

    streams = [None] * n_clips
    for sh, got in zip(shards, exchange.seq_gather_bytes(blobs)):
        if got is None:
            continue
        n_loc = sh.clips.stop - sh.clips.start
        bodies = [[] for _ in range(n_loc)]
        for blob in got:                            # in seq order
            lens = np.frombuffer(blob[:8 * n_loc], np.int64)
            ends = 8 * n_loc + np.concatenate([[0], np.cumsum(lens)])
            for j in range(n_loc):
                bodies[j].append(blob[ends[j]:ends[j + 1]])
        for j in range(n_loc):
            clip = sh.clips.start + j
            if clip < n_clips:
                streams[clip] = (encoder.header(cfg, int(nf_row[clip * nch]),
                                                n_samples[clip])
                                 + b"".join(bodies[j]))
    return streams


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def sharded_decode(data: bytes, grid: Grid, exchange):
    """MRC1 bytes -> (pcm [n, channels] float32, cfg), the frames sharded
    over "seq" and the channels over "data", on the exchange's device;
    bitwise equal to models.codec.decode(..., pcm_dtype="float32").

    Frames are padded to nf_pad = ceil((nf + 1) / S) * S (at least one pad
    frame: its hop carries the last frame's second half), channel rows to
    a multiple of n_data. Each shard's first hop adds the last second half
    of the shard before it (one f32 add, as the chunked decoder's seam
    add). Every process returns the whole PCM."""
    if exchange.grid != grid:
        raise ValueError("the exchange was made for another grid")
    cfg, nf, n_samples, _ = read_header(data)
    nch = cfg.channels
    q, e_band, bt = decoder.parse_records(data)
    nf_pad = -(-(nf + 1) // grid.n_seq) * grid.n_seq
    rows = -(-nch // grid.n_data) * grid.n_data
    qc = np.zeros((rows, nf_pad, C.LONG_COEFFS), np.int16)
    ec = np.zeros((rows, nf_pad, e_band.shape[1]), np.int16)
    bc = np.zeros((rows, nf_pad), np.int8)
    qc[:nch, :nf] = np.swapaxes(q.reshape(nf, nch, -1), 0, 1)
    ec[:nch, :nf] = np.swapaxes(e_band.reshape(nf, nch, -1), 0, 1)
    bc[:nch, :nf] = bt.reshape(nf, nch).T
    dev = exchange.device
    blocks = [(data_block(grid, d, rows), seq_block(grid, s, nf_pad))
              for d, s in exchange.local]

    def up(a, r, f):
        return torch.from_numpy(np.ascontiguousarray(a[r, f])).to(dev)

    outs = [decoder._synth_chunk(up(qc, r, f), up(ec, r, f), up(bc, r, f),
                                 cfg.fs, cfg.window, False)
            for r, f in blocks]
    prev, _ = exchange.halo([tail for _, _, tail in outs])
    pcm = []
    for (hops, first, _), p in zip(outs, prev):
        hops[:C.HOP] = (first + p).T       # the seam: one f32 add
        pcm.append(hops)
    full = np.zeros((nf_pad * C.HOP, rows), np.float32)
    for rank, piece in enumerate(exchange.world_gather(pcm)[0]):
        d, s = grid.coords(rank)
        r, f = data_block(grid, d, rows), seq_block(grid, s, nf_pad)
        full[f.start * C.HOP:f.stop * C.HOP, r] = piece.cpu().numpy()
    return np.ascontiguousarray(full[C.HOP:C.HOP + n_samples, :nch]), cfg
