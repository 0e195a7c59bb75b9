"""LMM zero-shot prompting harness (SURVEY §2.8; port of
vacnic_tpu/lmm/prompting.py).

Rebuilds `test_instructblip_prompt.py` / `test_llava_prompt.py`: prompt a
large multimodal model with the (optionally CLIP-retrieved) article and score
its caption against ground truth, emitting the same `{step: {gt, gen}}` JSON.

Backends are pluggable via `LmmBackend`:
  * `InstructBlipBackend` / `LlavaBackend` — HF transformers models
    (`Salesforce/instructblip-vicuna-7b`, `llava-hf/llava-1.5-7b-hf`,
    reference :95-97 / llava equivalent), constructed lazily and only when
    weights are available: `transformers` is imported when one is built, on
    "cuda" unless the caller passes another device. The reference's 4-bit
    BitsAndBytes quantization is not replicated.
  * `EchoBackend` — deterministic stub for pipeline tests.

Prompt format matches the reference exactly (instructblip:33-38):
`"News article:{article}Generate news image caption:"` with retrieval, else
`"Generate news image caption:"`.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Protocol, Sequence


def build_prompts(articles: Sequence[str], use_retrieval: bool) -> list[str]:
    if use_retrieval:
        return [f"News article:{a}Generate news image caption:" for a in articles]
    return ["Generate news image caption:"] * len(articles)


class LmmBackend(Protocol):
    name: str

    def generate(self, images: Sequence[Any], prompts: Sequence[str],
                 max_new_tokens: int = 50) -> list[str]: ...


class EchoBackend:
    """Deterministic stub: returns a fixed-form caption (pipeline tests)."""

    name = "echo"

    def generate(self, images, prompts, max_new_tokens: int = 50):
        return [f"a photo ({len(p)} prompt chars)" for p in prompts]


class _HFBackend:  # pragma: no cover - needs model weights
    model_id: str = ""

    def __init__(self, model_id: str | None = None, device=None, dtype=None):
        import torch
        from transformers import AutoModelForVision2Seq, AutoProcessor

        from vacnic_tpu_torch.core.device import resolve_device

        self.device = resolve_device(device)
        self.model_id = model_id or self.model_id
        self.name = self.model_id
        self.processor = AutoProcessor.from_pretrained(self.model_id)
        self.model = AutoModelForVision2Seq.from_pretrained(
            self.model_id, torch_dtype=dtype or torch.float32
        ).to(self.device)

    def generate(self, images, prompts, max_new_tokens: int = 50):
        inputs = self.processor(
            images=list(images), text=list(prompts), padding=True,
            truncation=True, return_tensors="pt",
        ).to(self.device)
        out = self.model.generate(**inputs, max_new_tokens=max_new_tokens)
        return self.processor.batch_decode(out, skip_special_tokens=True)


class InstructBlipBackend(_HFBackend):  # pragma: no cover
    model_id = "Salesforce/instructblip-vicuna-7b"


class LlavaBackend(_HFBackend):  # pragma: no cover
    model_id = "llava-hf/llava-1.5-7b-hf"


def prompt_captions(
    backend: LmmBackend,
    loader: Iterable[dict],
    *,
    use_retrieval: bool = True,
    max_new_tokens: int = 50,
    out_path: str | None = None,
) -> dict:
    """Loader batches need "article", "caption", "raw_img" (the reference's
    BLIP dataset contract, SURVEY §0.1 dataset_entity_type_newsmep_blip)."""
    out_dict: dict[int, dict] = {}
    for step, batch in enumerate(loader):
        prompts = build_prompts(batch["article"], use_retrieval)
        gen = backend.generate(batch["raw_img"], prompts, max_new_tokens)
        out_dict[step] = {"gt": batch["caption"], "gen": gen}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out_dict, f)
    return out_dict


def flatten_for_scoring(out_dict: dict) -> dict:
    """{step: {gt: [...], gen: [...]}} → per-sample {i: {gt, gen}} consumable
    by eval.caption_metrics / entity_eval."""
    flat: dict[int, dict] = {}
    i = 0
    for rec in out_dict.values():
        for gt, gen in zip(rec["gt"], rec["gen"]):
            flat[i] = {"gt": gt, "gen": gen}
            i += 1
    return flat
