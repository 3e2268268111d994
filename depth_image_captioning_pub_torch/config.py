"""Configuration dataclasses (the port's own copy of the JAX package's
``config.py``).

``ConfigTrain`` and ``ConfigEval`` keep the JAX package's field names and
default values, so a configuration reads the same in both packages
(``tests/test_torch_config.py`` compares them field by field). Fields that
name a JAX platform or mesh (``device``, ``mesh_shape``, ...) are kept for
that parity; the port's entry points take their device from their own
``device`` argument.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple


def _d(path: str) -> str:
    return os.path.join(os.getcwd(), path)


@dataclasses.dataclass
class ConfigTrain:
    """Training hyperparameters (the reference's config.py:3-71)."""

    # Model dimensions
    enc_img_size: int = 14        # attention grid side -> 196 regions
    dim_attention: int = 128
    dim_embedding: int = 128
    dim_encoder: int = 2048       # RGB annotation-vector channels
    dim_hidden: int = 128         # LSTM hidden size
    dim_l1: int = 128             # depth-MLP layer sizes
    dim_l2: int = 64
    dim_out: int = 32
    mlp_dim_encoder: int = 2080   # 2048 + 32 for concat fusion

    # Optimization
    lr: float = 1e-3
    dropout: float = 0.5
    batch_size: int = 30
    num_epochs: int = 150
    lr_drop: List[int] = dataclasses.field(default_factory=lambda: [20])
    temp_sch: int = 10            # hard-attention temperature update cadence
    grad_accum: int = 1           # microbatches per step
    decoder_dtype: str = "float32"  # decoder compute dtype for training
    checkpoint_keep: int = 0      # keep only the newest K checkpoints (0: all)

    # NIC
    nic_dim_embedding: int = 300
    num_layers: int = 2
    nic_dropout: float = 0.1

    # Sequence / decode
    max_length: int = 30          # greedy decode steps
    max_caption_len: int = 32     # train pad length (<start> + 30 + <end>)

    # Regularization / schedules
    alpha_reg: float = 0.7        # doubly-stochastic attention regularizer

    # Paths, relative to the working directory
    train_img_directory: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/train2014"))
    val_img_directory: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/val2014"))
    train_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/captions_train2014.json"))
    val_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/captions_val2014.json"))
    ori_train_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/original_dataset.json"))
    ori_val_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/original_val_dataset.json"))
    word_to_id_file: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/word_to_id.pkl"))
    ori_word_to_id_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/ori_word_to_id.pkl"))
    save_directory_soft: str = dataclasses.field(default_factory=lambda: _d("exp_result/base_soft"))
    save_directory_soft_ori: str = dataclasses.field(default_factory=lambda: _d("exp_result/base_soft_ori"))
    save_directory_Cdep_soft: str = dataclasses.field(default_factory=lambda: _d("exp_result/CNN_depth_soft"))
    save_directory_Cdep_soft_ori: str = dataclasses.field(default_factory=lambda: _d("exp_result/CNN_depth_soft_ori"))
    save_directory_hard: str = dataclasses.field(default_factory=lambda: _d("exp_result/base_hard"))
    save_directory_hard_ori: str = dataclasses.field(default_factory=lambda: _d("exp_result/base_hard_ori"))
    save_directory_Cdep_hard: str = dataclasses.field(default_factory=lambda: _d("exp_result/CNN_depth_hard"))
    save_directory_Cdep_hard_ori: str = dataclasses.field(default_factory=lambda: _d("exp_result/CNN_depth_hard_ori"))
    save_directory_nic: str = dataclasses.field(default_factory=lambda: _d("exp_result/NIC"))

    # Pretrained backbone weights
    resnet_weights: Optional[str] = None
    dpt_weights: Optional[str] = None
    dpt_image_size: int = 384     # DPT input resolution (224 -> 384 upscale)
    dpt_gelu: str = "erf"         # "erf" (exact) or "tanh"
    dpt_head: str = "full"        # "full" or "lowres"

    # Host data pipeline
    num_workers: int = 4

    # Device / execution (the JAX package's platform and mesh knobs)
    device: str = "tpu"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    seed: int = 123

    # Logging
    moving_avg: int = 100
    log_jsonl: bool = True
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_stop: int = 15

    def save_dir(self, kind: str, use_ori: bool) -> str:
        table = {
            ("soft", False): self.save_directory_soft,
            ("soft", True): self.save_directory_soft_ori,
            ("hard", False): self.save_directory_hard,
            ("hard", True): self.save_directory_hard_ori,
            ("depth_soft", False): self.save_directory_Cdep_soft,
            ("depth_soft", True): self.save_directory_Cdep_soft_ori,
            ("depth_hard", False): self.save_directory_Cdep_hard,
            ("depth_hard", True): self.save_directory_Cdep_hard_ori,
            ("nic", False): self.save_directory_nic,
            ("nic", True): self.save_directory_nic,
        }
        return table[(kind, use_ori)]


def _param_files(prefix: str, use_data: str,
                 with_depth: bool) -> Dict[int, List[str]]:
    """Checkpoint-filename tables (the reference's config.py:121-179)."""
    out = {}
    for i in range(3):
        files = [f"{prefix}_encoder_best_{use_data}{i}.pth",
                 f"{prefix}_decoder_best_{use_data}{i}.pth"]
        if with_depth:
            files.append(f"{prefix}_D_encoder_best_{use_data}{i}.pth")
        out[i + 1] = files
    return out


@dataclasses.dataclass
class ConfigEval(ConfigTrain):
    """Evaluation config: every training field, the eval batch size, the
    fixed-subset index files, checkpoint tables and sample-picture dirs."""

    batch_size: int = 50

    id_to_word_file: str = dataclasses.field(default_factory=lambda: _d("dataset/coco2014/id_to_word.pkl"))
    ori_id_to_word_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/ori_id_to_word.pkl"))
    rem_ori_val_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/rem_original_val_dataset.json"))
    remCOCO_ori_val_anno_file: str = dataclasses.field(default_factory=lambda: _d("dataset/original_dataset/remCOCO_original_val_dataset.json"))

    index_dir: str = dataclasses.field(default_factory=lambda: _d("data_index/np_val_index.npy"))
    Ori2000_index_dir: str = dataclasses.field(default_factory=lambda: _d("data_index/np_index_for_ori_val.npy"))
    remCOCO_500_ori_index_dir: str = dataclasses.field(default_factory=lambda: _d("data_index/remCOCO_500_ori.npy"))

    sample_dirs: Dict[str, str] = dataclasses.field(default_factory=lambda: {
        name: _d(f"sample_pic/{name}")
        for name in ("sample1", "sample2", "sample3", "airbus", "cycling",
                     "dog", "football", "soccer", "river", "seagull", "bird")
    })

    base_soft_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("base_soft", "coco", False))
    base_soft_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("base_soft", "original", False))
    base_hard_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("base_hard", "coco", False))
    base_hard_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("base_hard", "original", False))
    depth_soft_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("depth_soft", "coco", True))
    depth_soft_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("depth_soft", "original", True))
    depth_hard_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("depth_hard", "coco", True))
    depth_hard_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("depth_hard", "original", True))
    nic_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: {i + 1: [f"nic_encoder_best{i}.pth",
                                         f"nic_decoder_best{i}.pth"]
                                 for i in range(3)})
    mdepth_soft_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("mdepth_soft", "coco", True))
    mdepth_soft_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("mdepth_soft", "original", True))
    mdepth_hard_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("mdepth_hard", "coco", True))
    mdepth_hard_ori_parameter_files: Dict[int, List[str]] = dataclasses.field(
        default_factory=lambda: _param_files("mdepth_hard", "original", True))
