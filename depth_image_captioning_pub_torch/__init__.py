"""PyTorch + CUDA port of the depth-aware captioner, for NVIDIA Hopper.

A second package beside ``depth_image_captioning_pub_tpu`` (the JAX/Pallas
reference, which this package never imports). Module paths and names
mirror the JAX package's, so the counterpart of ``X`` there is ``X`` here.
Framework-free modules (``config``, ``data.tokenizer``, ``data.vocab``,
``data.pipeline``, ``metrics``) are imported from the JAX package, not
copied: they load neither JAX nor flax.

This slice is base-soft greedy captioning:

``ops``       image ops, pooling, soft attention, LSTM cell, and the CUDA
              kernels' Python wrappers (``ops.kernels``) with their plain
              PyTorch versions.
``csrc``      the hand-written CUDA C++ kernels for ``sm_90a``.
``models``    ResNet-152 grid encoder, attention decoder, captioner.
``engine``    ``make_caption_fn`` / ``generate_captions``.
``pipeline``  ``CaptionPipeline``: uint8 arrays in, captions out.
``utils``     ``jax_bridge.params_from_jax``: load the JAX package's
              parameter trees.
``cli``       ``python -m depth_image_captioning_pub_torch.cli caption``.
"""

__version__ = "0.1.0"
