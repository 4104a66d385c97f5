"""Generation in PyTorch: prefill + KV-cache decode with streamed text,
the non-streaming ``generate`` and fixed-width beam search.

Counterpart of ``llava_plus_tpu/generate.py``. PyTorch runs eagerly, so the
JAX package's compiled prefill/decode programs become plain calls;
``decode_chunk`` keeps its meaning (tokens are fetched to the host once per
chunk). Randomness comes from a ``torch.Generator`` on the model's device.
Each call that writes device state is an op with host arguments, so that
the tensor-parallel followers (``mesh=``, ``parallel/tp.py``) replay it.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch
from llava_plus_torch.mm_utils import tokenizer_image_token
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models import llama, llava as llava_model
from llava_plus_torch.models.llava import MultimodalBatch
from llava_plus_torch.parallel import tp as tp_lib


def nucleus(scaled: torch.Tensor, top_p) -> torch.Tensor:
    """``scaled`` [B, V] with the logits outside the top-p nucleus set to
    -inf: the fewest top tokens whose probability mass reaches ``top_p`` (a
    float, or a [B, 1] tensor); the top token always stays.

    The cutoff is the smallest kept logit. The JAX package takes the largest
    (``llava_plus_tpu/generate.py:sample_token`` and the engine's
    ``_sample_batch``), which keeps only the argmax, so its sampling is
    greedy at every temperature; the port samples the nucleus instead."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) < top_p
    cutoff = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= cutoff, scaled, -torch.inf)


def sample_token(logits: torch.Tensor, generator: torch.Generator,
                 temperature: float, top_p: float) -> torch.Tensor:
    """[B, V] f32 logits -> [B] token ids: argmax when temperature <= 0,
    else temperature + nucleus (top-p) sampling."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(nucleus(logits / max(temperature, 1e-6), top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def multimodal_arrays(
    cfg: LlavaConfig,
    tokenizer,
    prompts: Sequence[str],
    images_per_prompt: Optional[Sequence[Optional[np.ndarray]]] = None,
    *,
    max_seq_len: int,
    prefill_bucket: int = 128,
    max_images: int = 1,
):
    """Tokenize prompts (with <image> sentinels) and plan the fused batch on
    the host: ({field of :class:`MultimodalBatch`: numpy array}, plan)."""
    ids_list = [np.asarray(tokenizer_image_token(p, tokenizer), dtype=np.int64)
                for p in prompts]
    plan = plan_multimodal_batch(
        ids_list, num_patches=cfg.num_image_tokens, max_len=max_seq_len,
        max_images=max_images, pad_to_multiple=prefill_bucket,
    )
    img_hw = (cfg.vision.image_size, cfg.vision.image_size, 3)
    if images_per_prompt is None:
        images_per_prompt = [None] * len(prompts)
    imgs = pad_images(list(images_per_prompt), max_images, img_hw)
    arrays = {"tokens": plan.tokens, "positions": plan.positions,
              "segment_ids": plan.segment_ids, "images": imgs, "image_pos": plan.image_pos}
    return {k: np.ascontiguousarray(v) for k, v in arrays.items()}, plan


def batch_to_device(arrays, device) -> MultimodalBatch:
    """:func:`multimodal_arrays`' arrays as a batch on ``device``."""
    return MultimodalBatch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def prepare_multimodal_request(
    cfg: LlavaConfig,
    tokenizer,
    prompts: Sequence[str],
    images_per_prompt: Optional[Sequence[Optional[np.ndarray]]] = None,
    *,
    max_seq_len: int,
    device,
    prefill_bucket: int = 128,
    max_images: int = 1,
):
    """Tokenize prompts (with <image> sentinels) and build the fused batch."""
    arrays, plan = multimodal_arrays(cfg, tokenizer, prompts, images_per_prompt,
                                     max_seq_len=max_seq_len, prefill_bucket=prefill_bucket,
                                     max_images=max_images)
    return batch_to_device(arrays, device), plan


@dataclasses.dataclass
class GenerationResult:
    text: str
    output_ids: List[int]
    prompt_tokens: int
    completion_tokens: int


def reorder_beams(cache: llama.KVCache, parent: Sequence[int], start: int, end: int) -> None:
    """Row ``b`` of the dense ``cache``'s slots ``[start, end)`` <- row
    ``parent[b]``'s, in place: k, v (and their int8 scales) [L, B, S, ...]
    along dim 1, seg [B, S] along dim 0. Only the rows whose parent is
    another row move; each reads its parent's old values."""
    moved = [b for b, p in enumerate(parent) if p != b]
    if not moved or end <= start:
        return
    device = cache.seg.device
    dst = torch.tensor(moved, device=device)
    src = torch.tensor([parent[b] for b in moved], device=device)
    for buf in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if buf is not None:
            view = buf[:, :, start:end]
            view.index_copy_(1, dst, view.index_select(1, src))
    seg = cache.seg[:, start:end]
    seg.index_copy_(0, dst, seg.index_select(0, src))


def select_beams(logits: torch.Tensor, scores: torch.Tensor, done: torch.Tensor, nb: int):
    """One beam expansion: the top ``nb`` of the ``nb x V`` candidates
    ``scores[b] + log_softmax(logits[b])`` (f32), where a finished beam
    offers exactly one candidate, itself, frozen at column 0. Equal scores
    are taken lower flat index first, as ``jax.lax.top_k`` takes them.
    Returns (flat indices [nb] int64, their scores [nb] f32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    cand = torch.where(done[:, None], -torch.inf, scores[:, None] + logp)
    cand[:, 0] = torch.where(done, scores, cand[:, 0])
    top = torch.sort(cand.reshape(-1), descending=True, stable=True)
    return top.indices[:nb], top.values[:nb]


class Generator(tp_lib.Replicated):
    """Single-stream multimodal generation over one model on one device, or
    over a tensor-parallel group (``mesh``)."""

    def __init__(
        self,
        params,
        cfg: LlavaConfig,
        tokenizer,
        image_processor=None,
        *,
        device,
        max_seq_len: Optional[int] = None,
        prefill_bucket: int = 128,
        cache_dtype=torch.bfloat16,
        mesh=None,
    ):
        """``mesh`` (``make_mesh(1, 1, tp)``, or a process group) serves over
        tensor parallelism, one process a card (``parallel/tp.py``): each
        rank keeps its shard of ``params`` and a replica of the generation
        state; rank 0 calls :meth:`stream`, :meth:`generate` or
        :meth:`beam_search` and every other rank :meth:`follow`, until rank
        0's :meth:`stop`."""
        params = self._serve_over(mesh, params, cfg)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.device = torch.device(device)
        self.max_seq_len = max_seq_len or cfg.max_sequence_length
        self.prefill_bucket = prefill_bucket
        self.cache_dtype = cache_dtype
        self._st = {}   # the generation state the ops update

    def follow(self) -> int:
        """A follower rank's loop: replay rank 0's ops until it stops."""
        return self._follow()

    def stop(self):
        """End the followers' replay (rank 0 under tensor parallelism)."""
        self._end_followers()

    def _cache(self, batch: int) -> llama.KVCache:
        return llama.KVCache.create(llava_model.backbone(self.cfg)[1], batch, self.max_seq_len,
                                    self.cache_dtype, device=self.device)

    # -- ops: every call that writes device state, with host arguments ----

    def _op_stream_prefill(self, arrays, seed: int, temperature: float, top_p: float):
        """A stream's prefill into a fresh cache and its first token [1, 1]."""
        cache = self._cache(1)
        last = self._prefill(cache, batch_to_device(arrays, self.device))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        token = sample_token(last, generator, temperature, top_p)[:, None]
        self._st = {"cache": cache, "token": token, "generator": generator}
        return token

    def _op_stream_decode(self, pos: int, n: int, temperature: float, top_p: float):
        st = self._st
        toks = self._decode_n(st["cache"], st["token"], pos, n, st["generator"], temperature,
                              top_p)
        st["token"] = toks[:, -1:]
        return toks

    def _op_beam_prefill(self, arrays, nb: int):
        cache = self._cache(nb)
        logits = self._prefill(cache, batch_to_device(arrays, self.device))
        scores = np.asarray([0.0] + [-np.inf] * (nb - 1), np.float32)
        self._st = {"cache": cache, "logits": logits,
                    "scores": torch.from_numpy(scores).to(self.device),
                    "done": torch.zeros(nb, dtype=torch.bool, device=self.device)}
        return logits

    def _op_beam_select(self, nb: int, eos: int):
        """One expansion (:func:`select_beams`): (flat indices, scores)."""
        st = self._st
        V = st["logits"].shape[-1]
        idx, st["scores"] = select_beams(st["logits"], st["scores"], st["done"], nb)
        parent, st["tok"] = idx // V, idx % V
        st["done"] = st["done"][parent] | (st["tok"] == eos)
        return idx, st["scores"]

    def _op_beam_advance(self, parents: List[int], prompt_len: int, pos: int):
        """The cache reordered by parent beam, and one decode step."""
        st = self._st
        nb = len(parents)
        reorder_beams(st["cache"], parents, prompt_len, pos)
        position = torch.full((nb, 1), pos, dtype=torch.int32, device=self.device)
        logits, _ = llava_model.decode_step(self.params, self.cfg, st["tok"][:, None], position,
                                            (~st["done"]).to(torch.int32)[:, None], st["cache"])
        st["logits"] = logits[:, 0]

    def _prefill(self, cache, batch: MultimodalBatch) -> torch.Tensor:
        """Logits [B, V] at each sequence's last real token."""
        last = (batch.segment_ids.sum(dim=1) - 1).clamp_min(0)
        logits, _ = llava_model.forward(
            self.params, self.cfg, batch, cache=cache, fresh_prefill=True,
            logits_positions=last,
        )
        return logits[:, 0]

    def _decode_n(self, cache, token, pos: int, n: int, generator,
                  temperature: float, top_p: float) -> torch.Tensor:
        """``n`` decode steps from ``token`` [B, 1] at position ``pos``;
        returns the sampled tokens [B, n], still on the device."""
        B = token.shape[0]
        seg = torch.ones(B, 1, dtype=torch.int32, device=self.device)
        out = []
        for i in range(n):
            position = torch.full((B, 1), pos + i, dtype=torch.int32, device=self.device)
            logits, _ = llava_model.decode_step(self.params, self.cfg, token,
                                                position, seg, cache)
            token = sample_token(logits[:, 0], generator, temperature, top_p)[:, None]
            out.append(token)
        return torch.cat(out, dim=1)

    def prepare_batch(self, prompts, images_per_prompt=None, max_images: int = 1):
        return prepare_multimodal_request(
            self.cfg, self.tokenizer, prompts, images_per_prompt,
            max_seq_len=self.max_seq_len, device=self.device,
            prefill_bucket=self.prefill_bucket, max_images=max_images,
        )

    def _arrays(self, prompts, images_per_prompt=None):
        return multimodal_arrays(self.cfg, self.tokenizer, prompts, images_per_prompt,
                                 max_seq_len=self.max_seq_len,
                                 prefill_bucket=self.prefill_bucket)

    @torch.inference_mode()
    def stream(
        self,
        prompt: str,
        images: Optional[np.ndarray] = None,
        *,
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_p: float = 1.0,
        stop_strings: Sequence[str] = (),
        seed: int = 0,
        decode_chunk: int = 1,
    ) -> Iterator[str]:
        """Yield the cumulative generated text after each token.

        ``decode_chunk > 1`` runs that many decode steps before fetching
        their tokens to the host, and still yields token by token; the only
        waste is the tail of the chunk where EOS or a stop string landed.
        """
        arrays, plan = self._arrays([prompt], None if images is None else [images])
        prompt_len = int(plan.lengths[0])
        self._last_prompt_len = prompt_len
        self._last_output_ids: List[int] = []
        budget = min(max_new_tokens, self.max_seq_len - prompt_len)

        # reference CLIs pass None for "disabled"
        temp = float(temperature if temperature is not None else 0.0)
        tp = float(top_p if top_p is not None else 1.0)
        token = self._issue("stream_prefill", arrays, seed, temp, tp)

        eos = self.tokenizer.eos_token_id
        out_ids: List[int] = []
        pos = prompt_len
        emitted = 0
        pending: List[int] = []  # fetched but not yet emitted

        def emit(tid):
            """Append tid; return (text, done). None text = suppressed."""
            if tid == eos:
                return None, True
            out_ids.append(tid)
            self._last_output_ids = out_ids
            text = self.tokenizer.decode(out_ids, skip_special_tokens=True)
            for s in stop_strings:
                if s and s in text:
                    return text.split(s)[0], True
            return text, False

        # `token` holds the newest unemitted token; a decode may start only
        # once it has been emitted, since the decode consumes it.
        while emitted < budget:
            if pending:
                text, done = emit(pending.pop(0))
                if text is not None:
                    yield text
                emitted += 1
                if done:
                    break
                continue
            text, done = emit(int(token[0, 0]))
            if text is not None:
                yield text
            emitted += 1
            if done or emitted >= budget:
                break
            k = min(max(decode_chunk, 1), budget - emitted)
            toks = self._issue("stream_decode", pos, k, temp, tp)
            token = toks[:, -1:]
            pending = toks[0, :-1].tolist()
            pos += k

    @torch.inference_mode()
    def beam_search(
        self,
        prompt: str,
        images: Optional[np.ndarray] = None,
        *,
        num_beams: int,
        max_new_tokens: int = 128,
        length_penalty: float = 1.0,
        stop_strings: Sequence[str] = (),
    ) -> GenerationResult:
        """Vanilla fixed-width beam search (the eval CLIs' ``--num_beams``),
        JAX's rules: top-``nb`` selection over ``nb x V`` candidates,
        finished beams frozen in place, length-normalised finalisation with
        ``length_penalty``, stop strings cut the text at the end;
        ``num_beams <= 1`` is greedy :meth:`generate`.

        The beams are the batch: one prefill of ``nb`` identical rows, then a
        step is :func:`select_beams`, the cache reordered by parent beam and
        one decode of ``[nb, 1]`` tokens with ``seg`` 1 for live beams and 0
        for finished ones (whose logits the next selection ignores). The
        rows are identical up to the prompt, so only the slots written since
        (``[prompt_len, pos)``) move in :func:`reorder_beams`; the JAX
        package gathers the whole cache, which gives the same rows."""
        nb = int(num_beams)
        if nb <= 1:
            return self.generate(prompt, images, max_new_tokens=max_new_tokens,
                                 temperature=0.0, stop_strings=stop_strings)
        arrays, plan = self._arrays([prompt] * nb, None if images is None else [images] * nb)
        prompt_len = int(plan.lengths[0])
        budget = min(max_new_tokens, self.max_seq_len - prompt_len)
        eos = self.tokenizer.eos_token_id
        eos = -1 if eos is None else int(eos)

        # beam 0 starts live, the rest at -inf (the rows are identical
        # clones until the first expansion)
        V = self._issue("beam_prefill", arrays, nb).shape[-1]
        sc_h = np.asarray([0.0] + [-np.inf] * (nb - 1), np.float32)
        done_h = np.zeros(nb, bool)
        history: List[tuple] = []   # (tok[nb], parent[nb]) per step
        finished: List[tuple] = []  # (score_normalized, step_idx, beam)

        def reconstruct(t_end, beam):
            """Token path for ``beam`` through steps [0, t_end] inclusive."""
            ids, b = [], beam
            for t in range(t_end, -1, -1):
                tok_t, par_t = history[t]
                ids.append(int(tok_t[b]))
                b = int(par_t[b])
            return ids[::-1]

        pos = prompt_len
        for t in range(budget):
            idx, scores = self._issue("beam_select", nb, eos)
            idx_h = idx.cpu().numpy()
            sc_h = scores.cpu().numpy()
            par_h, tok_h = idx_h // V, idx_h % V
            was_h = done_h[par_h]
            done_h = was_h | (tok_h == eos)
            history.append((tok_h, par_h))
            for b in range(nb):
                if done_h[b] and not was_h[b]:
                    # freshly finished: t real tokens before this EOS
                    finished.append((sc_h[b] / max(t + 1, 1) ** length_penalty, t, b))
            if bool(done_h.all()) or t == budget - 1:
                break   # (JAX also decodes after the last selection, unread)
            self._issue("beam_advance", par_h.tolist(), prompt_len, pos)
            pos += 1

        t_last = len(history) - 1
        if finished:
            _, t_end, beam = max(finished, key=lambda f: f[0])
            ids = reconstruct(t_end, beam)[:-1]  # drop the EOS itself
        else:
            best = int(np.argmax(sc_h / max(t_last + 1, 1) ** length_penalty))
            ids = reconstruct(t_last, best)
        text = self.tokenizer.decode(ids, skip_special_tokens=True)
        for s in stop_strings:
            if s and s in text:
                text = text.split(s)[0]
        self._last_prompt_len = prompt_len
        self._last_output_ids = ids
        self._last_beam_steps = [(t.tolist(), p.tolist()) for t, p in history]
        return GenerationResult(text=text, output_ids=ids, prompt_tokens=prompt_len,
                                completion_tokens=len(ids))

    def generate(self, prompt: str, images: Optional[np.ndarray] = None,
                 **kw) -> GenerationResult:
        """The whole answer at once: :meth:`stream` in 32-token decode
        chunks unless the caller sets ``decode_chunk``."""
        kw.setdefault("decode_chunk", 32)
        text = ""
        for text in self.stream(prompt, images, **kw):
            pass
        return GenerationResult(text=text, output_ids=list(self._last_output_ids),
                                prompt_tokens=self._last_prompt_len,
                                completion_tokens=len(self._last_output_ids))
