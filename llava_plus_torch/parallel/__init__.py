"""The (dp, fsdp, tp) device mesh and the parameter spec tables for
training over DTensor (counterpart of ``llava_plus_tpu/parallel/``)."""
