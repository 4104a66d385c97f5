"""The eval harness on the port: answer runners over a loaded checkpoint
(``model_vqa*.py``, ``model_qa.py``, ``run_llava.py``), their scorers and
the GPT-judge scripts; the port's own copy of ``llava_plus_tpu/eval``."""
