"""Self-synchronization kernel (W&S, paper §IV-A): CUDA wrapper and plain
version.

Port of ``src/repro/kernels/huffman_selfsync.py``.  :func:`selfsync_intra`
finds each sequence's sync points: lane ``j`` of sequence ``s`` owns
subsequence ``s * subseqs_per_seq + j``, lane 0 starts at ``heads[s]`` and
every other lane at 0.  Each round every lane decodes its 128-bit window
from its current start, and lane ``j + 1``'s next start is lane ``j``'s
landing minus 128 (a synchronous round: all lanes decode from the previous
round's starts).  With ``early_exit`` the rounds stop at the fixed point
(the paper's ``__all_sync`` exit) or after ``subseqs_per_seq`` rounds;
without it, exactly ``subseqs_per_seq`` rounds run.  The inter-sequence
chaining of heads is ``ops.selfsync_sync``.

The wrapper launches ``csrc/selfsync_intra.cu`` for CUDA tensors (the LUT
staged in shared memory, or read from device memory when it does not fit
there) and runs :func:`selfsync_intra_plain` for CPU tensors; any other
device raises.
Its launches are counted in ``selfsync_intra.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core.huffman.encode import SUBSEQ_BITS
from repro_torch.kernels import _build
from repro_torch.kernels import common as C
from repro_torch.kernels import launches
from repro_torch.kernels.huffman_decode import (BLOCK_SMEM_RESERVED,
                                                SM_SMEM, SM_WARPS, SMEM_LIMIT,
                                                _check_smem, _check_stream,
                                                _expect, _stream_ptr)


def selfsync_lut_in_smem(subseqs_per_seq: int, lut: int) -> bool:
    """Whether ``selfsync_intra`` stages its ``lut``-entry LUT in shared
    memory (it fits beside what the block keeps there) or launches the
    variant that reads it from device memory.  Chosen by size, before the
    launch."""
    lanes = 0 if subseqs_per_seq <= 32 else 16 * subseqs_per_seq
    return lanes + 3 * lut <= SMEM_LIMIT


def selfsync_geometry(subseqs_per_seq: int, lut: int):
    """Launch geometry of :func:`selfsync_intra` for ``subseqs_per_seq``
    lanes a sequence and a ``lut``-entry LUT: ``(sequences a block, threads
    a block, shared memory bytes a block)``.

    Up to 32 lanes a sequence, one warp runs a sequence and a block holds
    several; its only shared memory is the LUT (uint16 symbol and uint8
    length per entry), staged once for all its sequences.  The block takes
    as many warps as it needs for the blocks that the SM's shared memory
    holds to fill the SM's 64 warps, at least 8 and at most 32 (8 at the
    default 4,096-entry LUT: eight blocks an SM).  Past 32 lanes one block
    of ``round_up(sps, 32)`` threads (at most 1,024) runs a sequence and
    also holds two start buffers, the landings and the counts of its lanes
    (int32 each).  A LUT that does not fit beside them
    (:func:`selfsync_lut_in_smem`) stays in device memory and takes no
    shared memory.
    """
    staged = 3 * lut if selfsync_lut_in_smem(subseqs_per_seq, lut) else 0
    if subseqs_per_seq <= 32:
        smem = staged
        fit = max(1, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
        warps = min(max(-(-SM_WARPS // fit), 8), 32)
        return warps, 32 * warps, smem
    threads = min(-(-subseqs_per_seq // 32) * 32, 1024)
    return 1, threads, 16 * subseqs_per_seq + staged


def selfsync_smem(subseqs_per_seq: int, lut: int) -> int:
    """Shared memory of one ``selfsync_intra`` block
    (:func:`selfsync_geometry`)."""
    return selfsync_geometry(subseqs_per_seq, lut)[2]


def end_local(n_seq: int, subseqs_per_seq: int, total_bits: int, device):
    """Row-local window ends, int64[n_seq, sps]: ``clip(min(b + 128,
    total_bits) - b, 0, 192)`` at each subsequence's boundary ``b``."""
    b = torch.arange(n_seq * subseqs_per_seq, dtype=torch.int64,
                     device=device) * SUBSEQ_BITS
    end = (torch.clamp(b + SUBSEQ_BITS, max=int(total_bits)) - b).clamp(
        0, C.ROW_UNITS * 32)
    return end.reshape(n_seq, subseqs_per_seq)


def selfsync_intra_plain(units, heads, total_bits: int, dec_sym, dec_len,
                         max_len: int, subseqs_per_seq: int,
                         early_exit: bool = True):
    """Plain version of :func:`selfsync_intra` (any device).

    All sequences run together in torch ops; a sequence drops out of the
    rounds once it reaches its fixed point (with ``early_exit``) or
    ``subseqs_per_seq`` rounds, and keeps the outputs of its own last
    round.
    """
    sps = subseqs_per_seq
    n_seq = heads.shape[0]
    device = units.device
    rows = C.gather_subseq_rows(
        units, torch.arange(n_seq * sps, device=device)).reshape(
            n_seq, sps, C.ROW_UNITS)
    end = end_local(n_seq, sps, total_bits, device)
    start = torch.zeros((n_seq, sps), dtype=torch.int64, device=device)
    start[:, 0] = heads[:, 0].to(torch.int64)
    landing = torch.zeros((n_seq, sps), dtype=torch.int32, device=device)
    counts = torch.zeros_like(landing)
    rounds = torch.zeros(n_seq, dtype=torch.int32, device=device)
    live = torch.arange(n_seq, device=device)
    while live.numel():
        cur = start[live]
        land, cnt = C.decode_window(rows[live].reshape(-1, C.ROW_UNITS),
                                    cur.reshape(-1), end[live].reshape(-1),
                                    dec_sym, dec_len, max_len)
        land = land.reshape(-1, sps)
        nxt = torch.cat([cur[:, :1], land[:, :-1].to(torch.int64) - 128], 1)
        changed = (nxt != cur).any(1)
        start[live] = nxt
        landing[live] = land
        counts[live] = cnt.reshape(-1, sps)
        rounds[live] += 1
        go = rounds[live] < sps
        if early_exit:
            go &= changed
        live = live[go]
    return (start.to(torch.int32), counts, landing,
            rounds.reshape(n_seq, 1))


@launches.counted
def selfsync_intra(units, heads, total_bits: int, dec_sym, dec_len,
                   max_len: int, subseqs_per_seq: int,
                   early_exit: bool = True):
    """Per-sequence sync discovery over the stream ``units``.

    units:  uint32[n_units], padded to whole sequences
    heads:  int32[n_seq, 1] start of each sequence's lane 0 (row-local)
    Returns ``(start, counts, landing, rounds)``: int32[n_seq, sps] each
    and int32[n_seq, 1].  ``start`` holds the starts after the last round
    (row-local; negative where a landing lies before bit 128 past the
    payload), ``counts`` and ``landing`` that round's decode (row-local),
    ``rounds`` the rounds each sequence ran.
    """
    _check_stream(units, dec_sym, dec_len, max_len, total_bits,
                  {"heads": heads})
    _expect("heads", heads, torch.int32)
    if heads.ndim != 2 or heads.shape[1] != 1:
        raise ValueError(f"heads must have shape (n_seq, 1), got "
                         f"{tuple(heads.shape)}")
    if subseqs_per_seq < 1:
        raise ValueError(f"subseqs_per_seq must be >= 1, got "
                         f"{subseqs_per_seq}")
    n_seq = heads.shape[0]
    if n_seq * subseqs_per_seq * SUBSEQ_BITS >= 2**31:
        raise ValueError(f"{n_seq} sequences of {subseqs_per_seq} "
                         f"subsequences leave the int32 bit range")
    if units.device.type == "cpu":
        return selfsync_intra_plain(units, heads, total_bits, dec_sym,
                                    dec_len, max_len, subseqs_per_seq,
                                    early_exit)
    lut = dec_sym.numel()
    seqs_per_block, threads, smem = selfsync_geometry(subseqs_per_seq, lut)
    _check_smem("selfsync_intra", smem)
    start = torch.empty((n_seq, subseqs_per_seq), dtype=torch.int32,
                        device=units.device)
    counts = torch.empty_like(start)
    landing = torch.empty_like(start)
    rounds = torch.empty((n_seq, 1), dtype=torch.int32, device=units.device)
    if n_seq == 0:
        return start, counts, landing, rounds
    launch = _build.load("selfsync_intra")
    rc = launch(units.data_ptr(), units.numel(), heads.data_ptr(), n_seq,
                subseqs_per_seq, int(total_bits), dec_sym.data_ptr(),
                dec_len.data_ptr(), lut, max_len,
                0 if selfsync_lut_in_smem(subseqs_per_seq, lut) else 1,
                int(bool(early_exit)),
                seqs_per_block, threads, smem, start.data_ptr(),
                counts.data_ptr(), landing.data_ptr(), rounds.data_ptr(),
                _stream_ptr(units.device))
    if rc != 0:
        raise RuntimeError(f"selfsync_intra kernel launch failed: CUDA "
                           f"error {rc}")
    launches.launched(selfsync_intra)
    return start, counts, landing, rounds
