# Frozen copy of rene_tpu_torch/scene/assets/__init__.py at commit ed2dcef.
