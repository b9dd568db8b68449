"""Frozen dataclass configuration tree of the PyTorch port.

A copy of the JAX package's config tree (``dcd_tpu/config/defaults.py``),
same knobs and defaults, so that one experiment reads the same in both
packages. The port copies it rather than importing it: the port imports
nothing of ``dcd_tpu``. YAML
experiment files with the reference's section layout (``runs/DGDE.yaml``)
load via :func:`load_yaml_config`, a copy of the JAX package's.

``model.backbone.dcn_impl`` takes the JAX package's values with their
meanings: ``"auto"`` and ``"pallas"`` are the hand-written kernels (their
wrappers take the plain version for tensors on the CPU), ``"dense"`` the
plain clamped version, ``"gather"`` the plain unbounded one and ``"plain"``
an ordinary conv that ignores the offsets (``models/layers.py::DCN``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional, Tuple

# Class-name -> class-id mapping (reference: DGDE/data/datasets/kitti.py:394-404)
TYPE_ID_CONVERSION = {
    "Car": 0,
    "Pedestrian": 1,
    "Cyclist": 2,
    "Van": -4,
    "Truck": -4,
    "Person_sitting": -2,
    "Tram": -99,
    "Misc": -99,
    "DontCare": -1,
}


@dataclass(frozen=True)
class InputConfig:
    # reference: DGDE/config/defaults.py:26-64
    height_train: int = 384
    width_train: int = 1280
    height_test: int = 384
    width_test: int = 1280
    pixel_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    pixel_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    to_bgr: bool = False
    modify_alpha: bool = False
    use_approx_center: bool = False
    heatmap_center: str = "3D"  # '2D' or '3D'
    adjust_boundary_heatmap: bool = False
    heatmap_ratio: float = 0.5
    ellip_gaussian: bool = False
    ignore_dont_care: bool = False
    keypoint_visible_modify: bool = False
    allow_outside_center: bool = False
    approx_3d_center: str = "intersect"
    orientation: str = "head-axis"  # or 'multi-bin'
    orientation_bin_size: int = 4
    # aug parameters; [[flip_prob]] or [[flip_prob, resize_prob]]
    aug_params: Tuple[Tuple[float, ...], ...] = ((0.5,),)
    # multi-scale training buckets (w, h); reference defaults.py:64
    multi_train_size: Tuple[Tuple[int, int], ...] = ()


@dataclass(frozen=True)
class DatasetsConfig:
    # reference: DGDE/config/defaults.py:69-96
    train: Tuple[str, ...] = ()
    test: Tuple[str, ...] = ()
    train_split: str = ""
    test_split: str = ""
    detect_classes: Tuple[str, ...] = ("Car", "Pedestrian", "Cyclist")
    filter_anno_enable: bool = False
    filter_annos: Tuple[float, float] = (0.9, 20)
    consider_outside_objs: bool = False
    max_objects: int = 40
    min_radius: float = 0.0
    max_radius: float = 0.0
    center_radius_ratio: float = 0.1
    max_classes_num: int = 3


@dataclass(frozen=True)
class BackboneConfig:
    # reference: DGDE/config/defaults.py:114-126
    conv_body: str = "dla34"
    down_ratio: int = 4
    # deformable-conv implementation, the JAX package's values: 'auto' or
    # 'pallas' (the hand-written kernels; plain version on CPU tensors),
    # 'dense' (plain, clamped), 'gather' (plain, unbounded), 'plain' (an
    # ordinary conv); the kernels and 'dense' clip the offsets to
    # [-dcn_radius, dcn_radius]
    dcn_impl: str = "auto"
    dcn_radius: int = 3
    # DLA-34 structure (reference: DGDE/model/backbone/dla_dcn.py:361-368)
    levels: Tuple[int, ...] = (1, 1, 1, 2, 2, 1)
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    last_level: int = 5


@dataclass(frozen=True)
class HeadConfig:
    # reference: DGDE/config/defaults.py:143-263
    predictor: str = "Base_Predictor"
    extra_kpts_num: int = 63
    loss_type: Tuple[str, ...] = ("Penalty_Reduced_FocalLoss", "L1", "giou", "berhu")
    heatmap_type: str = "centernet"
    loss_penalty_alpha: float = 2.0
    loss_beta: float = 4.0
    num_channel: int = 256
    use_normalization: str = "BN"
    active_func: str = "relu"
    regression_heads: Tuple[Tuple[str, ...], ...] = (
        ("2d_dim",),
        ("3d_offset",),
        ("3d_dim",),
        ("ori_cls", "ori_offset"),
        ("depth",),
    )
    regression_channels: Tuple[Tuple[int, ...], ...] = (
        (4,),
        (2,),
        (3,),
        (4, 2),
        (1,),
    )
    modify_invalid_keypoint_depth: bool = False
    bn_momentum: float = 0.1
    # deeper head variant (reference detector_predictor.py:47-49,134-151)
    deeper_head: bool = False
    stacked_convs: int = 2
    dcn_on_last_conv: bool = True
    uncertainty_init: bool = True
    uncertainty_range: Tuple[float, float] = (-10.0, 10.0)
    keypoint_loss: str = "L1"
    corner_loss_depth: str = "direct"
    keypoint_xy_weight: Tuple[float, float] = (1.0, 1.0)
    depth_mode: str = "inv_sigmoid"  # 'exp' | 'linear' | 'inv_sigmoid'
    depth_range: Tuple[float, float] = (0.1, 100.0)
    depth_reference: Tuple[float, float] = (26.494627, 16.05988)
    regression_offset_stat: Tuple[float, float] = (-0.5844396972302358, 9.075032501413093)
    use_uncertainty: bool = False
    loss_names: Tuple[str, ...] = (
        "hm_loss",
        "center_loss",
        "bbox_loss",
        "depth_loss",
        "offset_loss",
        "orien_loss",
        "dims_loss",
        "corner_loss",
    )
    init_loss_weight: Tuple[float, ...] = ()
    enable_edge_fusion: bool = False
    edge_fusion_kernel_size: int = 3
    edge_fusion_norm: str = "BN"
    edge_fusion_relu: bool = False
    truncation_offset_loss: str = "L1"
    truncation_output_fusion: str = "replace"
    output_depth: str = "direct"
    dimension_mean: Tuple[Tuple[float, float, float], ...] = (
        (3.8840, 1.5261, 1.6286),
        (0.8423, 1.7607, 0.6602),
        (1.7635, 1.7372, 0.5968),
    )
    dimension_std: Tuple[Tuple[float, float, float], ...] = (
        (0.4259, 0.1367, 0.1022),
        (0.2349, 0.1133, 0.1427),
        (0.1766, 0.0948, 0.1242),
    )
    dimension_reg: Tuple[Any, ...] = ("linear", True, False)
    dimension_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    init_p: float = 0.01
    center_mode: str = "max"
    # pairs-depth solve (reference: DGDE/model/anno_encoder.py:375-382)
    pairs_depth_clamp: Tuple[float, float] = (2.0, 80.0)
    pairs_topk: int = 1500

    @property
    def num_kpts(self) -> int:
        """Total keypoints per object: extra (CAD) + 10 box keypoints."""
        return self.extra_kpts_num + 10

    @property
    def reg_channels_flat(self) -> Tuple[Tuple[str, int], ...]:
        out = []
        for keys, chans in zip(self.regression_heads, self.regression_channels):
            for k, c in zip(keys, chans):
                out.append((k, c))
        return tuple(out)


@dataclass(frozen=True)
class SolverConfig:
    # reference: DGDE/config/defaults.py:282-329
    optimizer: str = "adamw"
    base_lr: float = 3e-3
    weight_decay: float = 1e-5
    max_iteration: int = 30000
    max_epochs: float = 70.0
    decay_epoch_steps: Tuple[float, ...] = (35.0, 45.0)
    steps: Tuple[int, ...] = (20000, 25000)
    lr_decay: float = 0.1
    lr_clip: float = 1e-7
    lr_warmup: bool = False
    warmup_steps: int = -1
    grad_norm_clip: float = 15.0
    bias_lr_factor: float = 2.0
    # adam_onecycle knobs (reference DGDE/config/defaults.py:290-292;
    # only used when optimizer == "adam_onecycle")
    moms: Tuple[float, float] = (0.95, 0.85)
    pct_start: float = 0.4
    div_factor: float = 10.0
    # process the batch as N sequential microbatches with one optimizer
    # update — peak activation memory of batch/N
    grad_accum_steps: int = 1
    ims_per_batch: int = 32
    save_checkpoint_interval: int = 1000
    save_checkpoint_epoch_interval: float = 5.0
    eval_interval: int = 2000


@dataclass(frozen=True)
class TestConfig:
    # reference: DGDE/config/defaults.py:334-361
    ims_per_batch: int = 1
    pred_2d: bool = True
    generate_gmw: bool = False
    uncertainty_as_confidence: bool = False
    # evaluate the regression heads only at the top-K heatmap peaks at
    # inference. The dense path (lazy_topk=False in the model call) stays
    # the reference-parity surface; outputs match up to matmul association.
    lazy_reg_heads: bool = True
    metric: Tuple[str, ...] = ("R40",)
    detections_per_img: int = 50
    detections_threshold: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    pretrain: bool = True
    pretrain_path: Optional[str] = None
    # top-level param subtrees to freeze in finetune mode (reference
    # MODEL.FREEZE_NAME, defaults.py:274 + check_point.py:78-96)
    freeze_names: Tuple[str, ...] = ()
    use_sync_bn: bool = False
    # recompute the forward of each microbatch in the backward
    # (torch.utils.checkpoint in engine/train.py; the JAX package's
    # jax.checkpoint): less activation memory for a second forward
    remat: bool = False
    reduce_loss_norm: bool = True
    norm: str = "BN"
    fp16: bool = False  # bf16 activations, fp32 parameters, in inference and training
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    batch_weight_factor: int = 18  # average obj num (defaults.py:276)


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    test: TestConfig = field(default_factory=TestConfig)
    output_dir: str = "./logs"
    seed: int = -1

    @property
    def output_width(self) -> int:
        return self.input.width_train // self.model.backbone.down_ratio

    @property
    def output_height(self) -> int:
        return self.input.height_train // self.model.backbone.down_ratio

    @property
    def max_edge_length(self) -> int:
        # boundary-ring buffer length (reference: DGDE/data/datasets/kitti.py:87)
        return (self.output_width + self.output_height) * 2


def default_config() -> Config:
    return Config()


def dgde_run_config() -> Config:
    """The shipped DGDE experiment (reference: ``DGDE/runs/DGDE.yaml:1-79``)."""
    cfg = Config(
        datasets=DatasetsConfig(
            detect_classes=("Car",),
            max_classes_num=1,
            train=("kitti_train",),
            test=("kitti_train",),
            train_split="train",
            test_split="val",
            consider_outside_objs=True,
            filter_anno_enable=True,
        ),
        input=InputConfig(
            heatmap_center="3D",
            aug_params=((0.5,),),
            orientation="multi-bin",
            orientation_bin_size=4,
            approx_3d_center="intersect",
            adjust_boundary_heatmap=True,
            keypoint_visible_modify=True,
        ),
        model=ModelConfig(
            use_sync_bn=True,
            head=HeadConfig(
                extra_kpts_num=63,
                regression_heads=(
                    ("2d_dim",),
                    ("3d_offset",),
                    ("corner_offset",),
                    ("corner_uncertainty",),
                    ("3d_dim",),
                    ("ori_cls", "ori_offset"),
                    ("depth",),
                    ("depth_uncertainty",),
                    ("extra_kpts_2d",),
                    ("extra_kpts_3d",),
                ),
                regression_channels=(
                    (4,),
                    (2,),
                    (20,),
                    (3,),
                    (3,),
                    (8, 8),
                    (1,),
                    (1,),
                    (146,),
                    (219,),
                ),
                enable_edge_fusion=True,
                truncation_output_fusion="add",
                edge_fusion_norm="BN",
                truncation_offset_loss="log",
                bn_momentum=0.1,
                use_normalization="BN",
                loss_type=("Penalty_Reduced_FocalLoss", "L1", "giou", "L1"),
                modify_invalid_keypoint_depth=True,
                corner_loss_depth="edges",
                loss_names=(
                    "hm_loss",
                    "bbox_loss",
                    "depth_loss",
                    "offset_loss",
                    "orien_loss",
                    "dims_loss",
                    "corner_loss",
                    "keypoint_loss",
                    "keypoint_depth_loss",
                    "trunc_offset_loss",
                    "extra_kpts_2d_loss",
                    "extra_kpts_3d_loss",
                    "pairs_kpts_depth_loss",
                ),
                init_loss_weight=(
                    1.0, 1.0, 0.2, 0.6, 1.0, 0.33, 0.025, 0.02, 0.066, 0.6, 1.0, 1.0, 0.3,
                ),
                center_mode="max",
                heatmap_type="centernet",
                dimension_reg=("exp", True, False),
                use_uncertainty=False,
                output_depth="edges",
                dimension_weight=(1.0, 1.0, 1.0),
                uncertainty_init=True,
            ),
        ),
        solver=SolverConfig(
            optimizer="adamw",
            base_lr=3e-4,
            weight_decay=1e-5,
            lr_warmup=True,
            warmup_steps=2000,
            lr_decay=0.1,
            save_checkpoint_epoch_interval=20.0,
            max_epochs=100.0,
            decay_epoch_steps=(80.0, 90.0),
            ims_per_batch=8,
            eval_interval=1000,
        ),
        test=TestConfig(
            uncertainty_as_confidence=True,
            detections_threshold=0.2,
            metric=("R40",),
        ),
    )
    return cfg


# ---------------------------------------------------------------------------
# YAML loading — accepts the reference's section/KEY layout.
# ---------------------------------------------------------------------------

_SECTION_MAP = {
    "INPUT": ("input", InputConfig),
    "DATASETS": ("datasets", DatasetsConfig),
    "SOLVER": ("solver", SolverConfig),
    "TEST": ("test", TestConfig),
}


def _coerce(value, current):
    """Coerce a YAML value toward the type of the current field value.

    YAML 1.1 parses ``1e-3`` (no dot) as a string; yacs coerced by target
    type, so we do too.
    """
    if isinstance(value, list):
        return tuple(_coerce(v, None) for v in value)
    if isinstance(value, str) and isinstance(current, (int, float)) and not isinstance(current, bool):
        try:
            f = float(value)
            return type(current)(f) if not isinstance(current, float) else f
        except ValueError:
            return value
    if isinstance(current, float) and isinstance(value, int):
        return float(value)
    return value


def _apply_section(dc, updates: Mapping[str, Any]):
    """Apply {UPPER_KEY: value} updates onto a dataclass by lowercased name."""
    fields = {f.name: f for f in dataclasses.fields(dc)}
    kwargs = {}
    nested = {}
    for key, value in updates.items():
        lname = key.lower()
        if lname in fields:
            kwargs[lname] = _coerce(value, getattr(dc, lname))
        elif isinstance(value, Mapping):
            nested[lname] = value
        # unknown keys are ignored (reference carries many vestigial knobs)
    out = replace(dc, **kwargs) if kwargs else dc
    for lname, value in nested.items():
        if lname in fields:
            sub = getattr(out, lname)
            out = replace(out, **{lname: _apply_section(sub, value)})
    return out


def load_yaml_config(path: str, base: Optional[Config] = None) -> Config:
    """Load a reference-layout YAML experiment file over a base config."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f) or {}

    cfg = base if base is not None else default_config()
    for section, updates in raw.items():
        if section == "MODEL":
            model = cfg.model
            model_updates = {k: v for k, v in updates.items() if not isinstance(v, Mapping)}
            model = _apply_section(model, model_updates)
            if "BACKBONE" in updates:
                model = replace(model, backbone=_apply_section(model.backbone, updates["BACKBONE"]))
            if "HEAD" in updates:
                model = replace(model, head=_apply_section(model.head, updates["HEAD"]))
            cfg = replace(cfg, model=model)
        elif section in _SECTION_MAP:
            attr, _ = _SECTION_MAP[section]
            cfg = replace(cfg, **{attr: _apply_section(getattr(cfg, attr), updates)})
        elif section == "OUTPUT_DIR":
            cfg = replace(cfg, output_dir=updates)
        elif section == "SEED":
            cfg = replace(cfg, seed=updates)
    return cfg
