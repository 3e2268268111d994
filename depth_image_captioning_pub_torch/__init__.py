"""PyTorch + CUDA port of the depth-aware captioner, for NVIDIA Hopper.

A second package beside ``depth_image_captioning_pub_tpu`` (the JAX/Pallas
reference, which this package never imports, not even its modules that
load no JAX: it keeps its own copies of what it uses, ``config``,
``data.tokenizer``, ``data.vocab``, ``data.pipeline``, ``data.coco``,
``data.synthetic`` and ``metrics``). Module paths
and names mirror the JAX package's, so the counterpart of ``X`` there is
``X`` here. Entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``, ``--device cpu``).

The ported paths are the seven kinds' captioning (greedy, beam search,
sampling), the scored evaluation of checkpoint sets, serving, and
training:

``config``    ``ConfigTrain`` / ``ConfigEval``.
``data``      special tokens, tokenizer, vocabulary, train and eval
              batches, the COCO reader, synthetic sets.
``metrics``   BLEU-1..4, METEOR, ROUGE-L, CIDEr.
``ops``       image ops (incl. the DPT's resize/normalize/standardize),
              pooling, soft and hard attention, LSTM cell and stacked
              step, beam
              search (``ops.decode``), and the CUDA kernels' Python
              wrappers (``ops.kernels``) with their plain PyTorch versions.
``csrc``      the hand-written CUDA C++ kernels for ``sm_90a``.
``models``    ResNet-152 grid encoder, DPT-hybrid depth estimator, depth
              CNN encoder, attention decoder (add fusion), NIC decoder,
              captioner.
``engine``    ``make_caption_fn`` / ``generate_captions`` / ``evaluate``;
              ``losses``, ``steps``, ``depth_cache``, ``train``.
``pipeline``  ``CaptionPipeline``: uint8 arrays in, captions out;
              ``from_experiment`` loads a checkpoint set.
``utils``     ``jax_bridge`` (``params_from_jax`` / ``params_to_jax`` /
              ``dpt_params_from_jax``: the JAX package's parameter
              trees), ``checkpoint`` and ``msgpack_codec`` (the JAX
              trainer's flax msgpack files).
``cli``       ``python -m depth_image_captioning_pub_torch.cli caption``.
``evaluation`` ``python -m depth_image_captioning_pub_torch.evaluation``:
              score checkpoint sets.
``training``  ``python -m depth_image_captioning_pub_torch.training``:
              train a kind, writing the JAX trainer's files.
"""

__version__ = "0.1.0"
