"""PyTorch + CUDA port of the depth-aware captioner, for NVIDIA Hopper.

A second package beside ``depth_image_captioning_pub_tpu`` (the JAX/Pallas
reference, which this package never imports, not even its modules that
load no JAX: it keeps its own copies of what it uses, ``config``,
``data.tokenizer``, ``data.vocab`` and ``data.pipeline``). Module paths
and names mirror the JAX package's, so the counterpart of ``X`` there is
``X`` here. Entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu``).

The ported paths are NIC, base-soft and depth-soft captioning, greedy and
beam search:

``config``    ``ConfigTrain`` / ``ConfigEval``.
``data``      special tokens, detokenizer, vocabulary, eval batches.
``ops``       image ops (incl. the DPT's resize/normalize/standardize),
              pooling, soft attention, LSTM cell and stacked step, beam
              search (``ops.decode``), and the CUDA kernels' Python
              wrappers (``ops.kernels``) with their plain PyTorch versions.
``csrc``      the hand-written CUDA C++ kernels for ``sm_90a``.
``models``    ResNet-152 grid encoder, DPT-hybrid depth estimator, depth
              CNN encoder, attention decoder (add fusion), NIC decoder,
              captioner.
``engine``    ``make_caption_fn`` / ``generate_captions``.
``pipeline``  ``CaptionPipeline``: uint8 arrays in, captions out.
``utils``     ``jax_bridge.params_from_jax`` / ``dpt_params_from_jax``:
              load the JAX package's parameter trees.
``cli``       ``python -m depth_image_captioning_pub_torch.cli caption``.
"""

__version__ = "0.1.0"
