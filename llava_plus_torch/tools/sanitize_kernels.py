"""Launch each attention kernel and the int8 and int4 matmuls of the port
once, for a memory checker.

Runs the flash forward, dK/dV and dQ kernels (plain and ALiBi; MHA and MQA,
whose dK/dV splits the query heads; a ragged T), the dense decode kernel
(bf16 and int8 caches, one chunk and many, G = 1 and 32), both paged
kernels (decode1 and the general one, bf16 and int8 pools, decode1 also
over pages of 32 and over the paged engine's 32 pages of 128, the general
one also for 8-token chunks over 32 pages and for a group of 16 rows, two
blocks of 8),
both int8 and both int4 weight-only kernels (decode rows with one K chunk
and several, prefill rows with one and several, bf16 and f32 out) and both
native int4 kernels (each with a K-chunked plan, and at a shape whose N is
not a multiple of 128) at the shapes ``chip_smoke.py`` phase 3 gives them,
synchronizing after each, so that a checker wrapped around the process sees
every kernel:

    compute-sanitizer --tool memcheck python3 -m llava_plus_torch.tools.sanitize_kernels
    compute-sanitizer --tool racecheck python3 -m llava_plus_torch.tools.sanitize_kernels --small

``--small`` cuts T, the cache, the batch and the matrices (racecheck tracks
every shared-memory access and is slow at full size). Each line names a launch;
the last says how many ran. Any CUDA error raises.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from llava_plus_torch.tools.common import describe_device


def _flash(launch, gen, T, B, H, Hkv, alibi, causal=True):
    from llava_plus_torch.models.mpt import alibi_slopes
    from llava_plus_torch.ops import flash_attention as fa

    D = 128
    dev = "cuda"
    q = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).bfloat16()
    do = torch.randn(B, T, H, D, generator=gen, device=dev).bfloat16()
    seg = torch.ones(B, T, dtype=torch.int32, device=dev)
    seg[0, T - T // 20:] = 0
    seg[-1, T // 2:] = 2
    slopes = alibi_slopes(H, 8, dev) if alibi else None
    qp, kp, vp, qs, ks = fa._pad_inputs(q, k, v, seg, seg)
    tag = f"T={T} B={B} H={H} Hkv={Hkv}{' alibi' if alibi else ''}{'' if causal else ' non-causal'}"
    out, lse = fa._launch(qp, kp, vp, qs, ks, causal, D ** -0.5, slopes)
    launch(f"flash_fwd {tag}")
    dop = torch.nn.functional.pad(do, (0, 0, 0, 0, 0, qp.shape[1] - T)).contiguous()
    delta = (dop.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    kw = dict(causal=causal, sm_scale=D ** -0.5, alibi_slopes=slopes)
    fa.flash_bwd_dkv(qp, kp, vp, dop, qs, ks, lse, delta, **kw)
    launch(f"flash_bwd_dkv {tag} (head splits {fa.flash_bwd_dkv.last_splits})")
    fa.flash_bwd_dq(qp, kp, vp, dop, qs, ks, lse, delta, **kw)
    launch(f"flash_bwd_dq {tag}")


def _decode(launch, gen, rng, B, S, H, Hkv, int8, alibi, fill_max):
    from llava_plus_torch.models.llama import quantize_kv
    from llava_plus_torch.models.mpt import alibi_slopes
    from llava_plus_torch.ops.decode_attention import decode_attention

    D, dev = 128, "cuda"
    q = torch.randn(B, 1, H, D, generator=gen, device=dev).bfloat16()
    kc = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    vc = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    fills = rng.integers(1, fill_max + 1, size=B)
    if B > 1:
        fills[0] = 1   # and row 1's visible slots all segment 0
    seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
    for b, f in enumerate(fills):
        seg[b, :f] = 0 if b == 1 else 1
    q_pos = torch.as_tensor(fills - 1, dtype=torch.int32, device=dev)
    ks = vs = None
    if int8:
        (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
    slopes = alibi_slopes(H, 8, dev) if alibi else None
    decode_attention(q, kc, vc, seg, q_pos, ks, vs, alibi_slopes=slopes)
    launch(f"decode B={B} S={S} H={H} Hkv={Hkv} {'int8' if int8 else 'bf16'}"
           f"{' alibi' if alibi else ''} (chunks {decode_attention.last_splits})")


def _paged(launch, gen, rng, B, Hkv, Tq, int8, alibi, pages_per_slot, H=32, P=128):
    from llava_plus_torch.models.llama import _paged_quant
    from llava_plus_torch.models.mpt import alibi_slopes
    from llava_plus_torch.ops import paged_attention as pa

    D, dev = 128, "cuda"
    NP = B * pages_per_slot
    page_ids = torch.as_tensor(rng.permutation(NP).reshape(B, pages_per_slot),
                               dtype=torch.int32, device=dev)
    lengths = rng.integers(1, pages_per_slot * P + 1, size=B)
    valid = rng.integers(1, Tq + 1, size=B)
    lengths[-1] = valid[-1] = 0
    pool = torch.randn(NP, 2, P, Hkv, D, generator=gen, device=dev).bfloat16()
    scale = None
    if int8:
        pool, scale = _paged_quant(pool)
        scale = scale.transpose(2, 3).contiguous()
    q = torch.randn(B, Tq, H, D, generator=gen, device=dev).bfloat16()
    ck = torch.randn(B, Tq, Hkv, D, generator=gen, device=dev).bfloat16()
    cv = torch.randn(B, Tq, Hkv, D, generator=gen, device=dev).bfloat16()
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    vals = torch.as_tensor(valid, dtype=torch.int32, device=dev)
    slopes = alibi_slopes(H, 8, dev) if alibi else None
    pa.paged_decode_attention(q, pool, page_ids, lens, scale, ck, cv, vals, alibi_slopes=slopes)
    kind = "decode1" if (H // Hkv) * Tq == 1 else "general"
    launch(f"paged {kind} B={B} H={H} Hkv={Hkv} Tq={Tq} {'int8' if int8 else 'bf16'}"
           f"{' alibi' if alibi else ''}")


def _quant(launch, gen, kind, R, K, N, f32):
    from llava_plus_torch.ops import quant, quant_matmul as qm

    dev = "cuda"
    w = torch.randn(K, N, generator=gen, device=dev).mul_(0.02).bfloat16()
    x = torch.randn(R, K, generator=gen, device=dev).bfloat16()
    if kind == "int4n":
        qm.matmul_int4_native(x, *quant.quantize_array_int4_native(w))
        regime, splits, _ = qm.matmul_int4_native.last_plan
        launch(f"int4 native R={R} K={K} N={N} f32 out ({regime}, {splits} K chunks)")
        return
    if kind == "int8":
        q, wrapper = quant.quantize_array(w), qm.matmul_int8
        qw = q[quant.QKEY]
    else:
        q, wrapper = quant.quantize_array_int4(w), qm.matmul_int4
        qw = q[quant.Q4KEY]
    wrapper(x, qw, q[quant.SKEY], out_dtype=torch.float32 if f32 else torch.bfloat16)
    regime, splits, _ = wrapper.last_plan
    launch(f"{kind} R={R} K={K} N={N} {'f32' if f32 else 'bf16'} out ({regime}, {splits} K "
           f"chunks)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="T = 320, caches of 512 slots, 4 rows (for racecheck)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 1
    print(describe_device("cuda"), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    count = [0]

    def launch(what):
        torch.cuda.synchronize()   # a fault of this launch surfaces here
        count[0] += 1
        print(f"[sanitize] {what}: ok", flush=True)

    T, ragged, B, S, slots, pages = ((320, 192, 2, 512, 4, 4) if args.small
                                     else (2048, 1984, 2, 1024, 16, 16))
    for H, Hkv, alibi in ((32, 32, False), (32, 8, False), (32, 32, True), (32, 1, True)):
        _flash(launch, gen, T, B, H, Hkv, alibi)
    _flash(launch, gen, ragged, B, 32, 1, True)
    _flash(launch, gen, T // 4, B, 32, 1, True, causal=False)
    for B_, S_, Hkv, int8, alibi, fill in ((slots, S, 32, False, False, S),
                                           (slots, S, 32, True, True, S),
                                           (slots, S, 1, False, False, S),
                                           (slots, 2 * S, 1, True, True, 900 * S // 1024),
                                           (1, 2 * S, 32, False, False, 2 * S - 348),
                                           (1, 2 * S, 32, True, False, 2 * S - 348)):
        _decode(launch, gen, rng, B_, S_, 32, Hkv, int8, alibi, fill)
    for Hkv, Tq, int8, alibi in ((32, 1, False, False), (32, 1, True, True),
                                 (8, 1, True, False), (32, 4, False, False),
                                 (32, 4, True, True)):
        _paged(launch, gen, rng, slots, Hkv, Tq, int8, alibi, pages)
    _paged(launch, gen, rng, slots, 32, 1, True, False, 4 * pages, P=32)
    # decode1 at the paged engine's 32 pages a slot (twice the chunks); the
    # general kernel's 8-token chunks there (ALiBi), and 16 rows a kv head
    # (two blocks of 8)
    _paged(launch, gen, rng, slots, 32, 1, True, True, 2 * pages)
    _paged(launch, gen, rng, slots, 32, 8, True, True, 2 * pages)
    _paged(launch, gen, rng, slots, 2, 1, False, False, pages, H=32)
    K, N = (1024, 1536) if args.small else (4096, 12288)
    for kind, cases in (
            ("int8", ((1, K, N, False), (16, K, N, False), (32, 11008, 4096, False),
                      (16, K, 32000, True), (33, K, N, False), (64, 11008, 4096, False),
                      (768, K, N, False), (768, K, 32000, True))),
            ("int4", ((1, K, N, False), (16, K, N, False), (48, 11008, 4096, False),
                      (16, K, 32000, True), (49, K, N, False), (64, 11008, 4096, False),
                      (768, K, N, False), (768, K, 32000, True), (8192, 11008, 4096, False))),
            ("int4n", ((16, K, 4096, True), (48, 1152, 4160, True), (64, 11008, 4096, True),
                       (200, 1152, 4160, True), (768, 11008, 4096, True)))):
        for R, K_, N_, f32 in cases:
            if args.small:
                K_, N_, R = min(K_, K), min(N_, N), min(R, 200)
            _quant(launch, gen, kind, R, K_, N_, f32)
    print(f"[sanitize] {count[0]} launches, every one synchronized without a CUDA error",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
