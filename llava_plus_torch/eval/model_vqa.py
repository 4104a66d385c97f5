"""Plain batch VQA runner (ref llava/eval/model_vqa.py): same contract as
model_vqa_loader without the prefetching DataLoader.

The port's own copy of ``llava_plus_tpu/eval/model_vqa.py``.
"""

from llava_plus_torch.eval.model_vqa_loader import build_parser, eval_model, main  # noqa: F401

if __name__ == "__main__":
    main()
