"""Generation in PyTorch: prefill + KV-cache decode with streamed text.

Counterpart of ``llava_plus_tpu/generate.py`` (beam search and the
non-streaming ``generate`` are not ported yet). PyTorch runs eagerly, so the
JAX package's compiled prefill/decode programs become plain calls; ``decode_chunk`` keeps its meaning (tokens are
fetched to the host once per chunk). Randomness comes from a
``torch.Generator`` on the model's device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from llava_plus_torch.data.multimodal import pad_images, plan_multimodal_batch
from llava_plus_torch.mm_utils import tokenizer_image_token
from llava_plus_torch.models.configs import LlavaConfig
from llava_plus_torch.models import llama, llava as llava_model
from llava_plus_torch.models.llava import MultimodalBatch


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

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    batch = MultimodalBatch(
        tokens=dev(plan.tokens), positions=dev(plan.positions),
        segment_ids=dev(plan.segment_ids), images=dev(imgs),
        image_pos=dev(plan.image_pos),
    )
    return batch, plan


class Generator:
    """Single-stream multimodal generation over one model on one device."""

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
    ):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.device = torch.device(device)
        self.max_seq_len = max_seq_len or cfg.max_sequence_length
        self.prefill_bucket = prefill_bucket
        self.cache_dtype = cache_dtype

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
        batch, plan = self.prepare_batch([prompt], None if images is None else [images])
        prompt_len = int(plan.lengths[0])
        self._last_prompt_len = prompt_len
        self._last_output_ids: List[int] = []
        budget = min(max_new_tokens, self.max_seq_len - prompt_len)

        cache = llama.KVCache.create(llava_model.backbone(self.cfg)[1], 1, self.max_seq_len,
                                     self.cache_dtype, device=self.device)
        last_logits = self._prefill(cache, batch)
        # reference CLIs pass None for "disabled"
        temp = float(temperature if temperature is not None else 0.0)
        tp = float(top_p if top_p is not None else 1.0)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        token = sample_token(last_logits, generator, temp, tp)[:, None]

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
            toks = self._decode_n(cache, token, pos, k, generator, temp, tp)
            token = toks[:, -1:]
            pending = toks[0, :-1].tolist()
            pos += k
