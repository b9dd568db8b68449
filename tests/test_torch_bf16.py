"""The port's bf16 inference path (``cfg.model.fp16``) against the JAX
package's, on the CPU.

Both packages keep parameters in fp32 and run activations in bf16; the same
numpy-drawn weights are carried into the port with ``from_jax_variables``.
Outputs must agree to 2e-2 of their largest magnitude (bf16's rounding step
is 2^-8; the two frameworks round at a few other places).

The comparison is made where it measures the port rather than the network:
on the heads (fed the same bf16 features), on single blocks, and over the
small detector's whole forward block by block, each backbone block in its
place fed JAX's input of it. Free-running, the two packages' whole bf16
forwards part about as widely as each one's bf16 forward parts from its
own fp32 forward (with calibrated BN, one flipped bf16 rounding grows into
an unrelated forward); a test measures that gap in both packages. The
end-to-end test of ``build_detector`` holds the port's bf16 forward to
types, shapes and finiteness and to the launch contract of the DCN.

The JAX side runs its DCN in the Pallas kernel's interpret mode, the form
that receives fp32 offsets as the port's kernel does; its gather form adds
positions in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcd_tpu.data.synthetic import KITTI_P2
from dcd_tpu.engine.infer import postprocess as jax_postprocess
from dcd_tpu.models.detector import KeypointDetector as JaxDetector
from dcd_tpu.models.dla import DeformConvBlock as JaxDeformConvBlock
from dcd_tpu.models.dla import DLASeg as JaxDLASeg
from dcd_tpu.models.dla import DLAUp as JaxDLAUp
from dcd_tpu.models.dla import IDAUp as JaxIDAUp
from dcd_tpu.models.dla import Tree as JaxTree
from dcd_tpu.models.layers import BilinearUp as JaxBilinearUp
from dcd_tpu.models.predictor import Predictor as JaxPredictor
from dcd_tpu_torch.engine.infer import build_detector, infer, postprocess
from dcd_tpu_torch.models.detector import KeypointDetector
from dcd_tpu_torch.models.dla import DLAUp, IDAUp, Tree
from dcd_tpu_torch.models.layers import DeformConv, bilinear_up
from dcd_tpu_torch.models.predictor import Converter_key2channel, Predictor
from dcd_tpu_torch.ops import dcn_cuda
from dcd_tpu_torch.utils.weights import from_jax_variables, load_state
from torch_port_common import (HEAD_CHANNELS, calibrated_variables, edge_inputs, small_configs,
                               with_dcn)
from torch_port_common import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-2
B = 2


def _fp16(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fp16=True))


def _draw(shapes, rng, offset_scale=0.05):
    """Numpy leaves for flax variable shapes: He-normal kernels, BN scale and
    variance in [0.5, 1.5], small offset convs."""
    def draw(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], s.shape
        if "conv_offset_mask" in names:
            return (rng.randn(*shape) * (offset_scale if leaf == "kernel" else 0.4)).astype(np.float32)
        if leaf == "kernel":
            return (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bf16(a):
    """A numpy array rounded to bf16, kept as fp32 (both sides get its values)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{name}: max abs err {err} vs scale {scale}"


def _load(module, variables, cfg, prefix=""):
    sd = {k[len(prefix):]: v for k, v in from_jax_variables(variables, cfg).items()}
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    missing = {k for k in module.state_dict() if not k.endswith("num_batches_tracked")} - set(sd)
    assert not missing, sorted(missing)[:5]
    return module.eval()


# ------------------------------------------------------------------ heads


@pytest.fixture(scope="module")
def heads_pair():
    """Both packages' heads in bf16 on the same bf16 features, the lazy
    top-K path that inference runs, and the rows after each postprocess."""
    jcfg, tcfg = (_fp16(c) for c in small_configs())
    rng = np.random.RandomState(31)
    H, W = jcfg.output_height, jcfg.output_width
    feats = _bf16(np.maximum(rng.randn(B, H, W, HEAD_CHANNELS), 0))
    ei, el = edge_inputs(jcfg, B, rng)
    heads = JaxPredictor(jcfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda r: heads.init(r, feats, ei, el, train=False), jax.random.PRNGKey(0))
    variables = _draw(shapes, rng)
    out_j = jax.jit(lambda v, *a: heads.apply(v, *a, train=False, lazy_topk=True))(
        variables, jnp.asarray(feats, jnp.bfloat16), ei, el)
    out_j = {k: np.asarray(v, np.float32) for k, v in out_j.items()}

    model = _load(Predictor(tcfg, HEAD_CHANNELS), {k: {"heads": v} for k, v in variables.items()},
                  tcfg, prefix="heads.")
    with torch.no_grad():
        out_t = model(torch.from_numpy(feats).bfloat16().permute(0, 3, 1, 2),
                      torch.from_numpy(ei).long(), torch.from_numpy(el).long(), lazy_topk=True)

    calib = np.tile(KITTI_P2[None], (B, 1, 1)).astype(np.float32)
    pad = np.tile([[4.0, 2.0]], (B, 1)).astype(np.float32)
    size = np.tile([[120.0, 60.0]], (B, 1)).astype(np.float32)
    rows_j = jax.tree.map(np.asarray, jax.jit(lambda p, *a: jax_postprocess(jcfg, p, *a))(
        out_j, calib, pad, size))
    rows_t = postprocess(tcfg, out_t, *map(torch.from_numpy, (calib, pad, size)))
    return dict(cfg=tcfg, out_j=out_j, out_t=out_t, rows_j=rows_j, rows_t=rows_t)


def _matched(pair):
    """(image, port index, JAX index) of the peaks both chose: a peak whose
    bf16 score ties a neighbour's may give way to another."""
    pt, pj = pair["out_t"]["points_xy"].numpy(), pair["out_j"]["points_xy"]
    out = []
    for b in range(pt.shape[0]):
        where = {tuple(p): i for i, p in enumerate(pt[b])}
        out += [(b, where[tuple(p)], j) for j, p in enumerate(pj[b]) if tuple(p) in where]
    assert len(out) >= 0.9 * pt.shape[0] * pt.shape[1], f"{len(out)} peaks in common"
    return tuple(np.array(x) for x in zip(*out))


def test_bf16_heads_output_types(heads_pair):
    out = heads_pair["out_t"]
    for key in ("cls", "reg_pois", "scores", "points_xy"):
        assert out[key].dtype == torch.float32, key
    assert heads_pair["rows_t"]["dets"].dtype == torch.float32


def test_bf16_heatmap_matches_jax(heads_pair):
    _close(heads_pair["out_t"]["cls"].numpy(), heads_pair["out_j"]["cls"], "cls")
    b, it, ij = _matched(heads_pair)
    _close(heads_pair["out_t"]["scores"].numpy()[b, it], heads_pair["out_j"]["scores"][b, ij],
           "scores")


@pytest.mark.parametrize("key", [k for k, _ in small_configs()[1].model.head.reg_channels_flat])
def test_bf16_regression_head_matches_jax(heads_pair, key):
    head = heads_pair["cfg"].model.head
    sl = Converter_key2channel(head.regression_heads, head.regression_channels)(key)
    b, it, ij = _matched(heads_pair)
    _close(heads_pair["out_t"]["reg_pois"].numpy()[b, it, sl],
           heads_pair["out_j"]["reg_pois"][b, ij, sl], key)


def test_bf16_rows_match_jax(heads_pair):
    """KITTI rows through both postprocesses (fp32), matched by 2D box centre
    and depth; every column within 2e-2 of its largest magnitude."""
    dets_j, valid_j = heads_pair["rows_j"]["dets"], heads_pair["rows_j"]["valid"]
    dets_t = heads_pair["rows_t"]["dets"].numpy()
    assert np.isfinite(dets_t).all() and valid_j.any()
    scale = np.abs(dets_j).max(axis=(0, 1))
    centre = lambda d: np.stack([d[:, 2] + d[:, 4], d[:, 3] + d[:, 5], d[:, 11]], 1)
    hits = total = 0
    for b in range(B):
        cj, ct = centre(dets_j[b]), centre(dets_t[b])
        for i in range(len(cj)):
            j = int(np.argmin(np.abs(ct - cj[i]).sum(1)))
            total += 1
            hits += bool(np.all(np.abs(dets_t[b, j] - dets_j[b, i]) <= TOL * scale + 1e-5))
    assert hits >= 0.9 * total, f"{hits} of {total} rows matched"


# ----------------------------------------------------------------- blocks


def _block(kind, rng):
    """(JAX module, port module, inputs NHWC) of one block in bf16; the
    decoder's blocks take a list of levels, each half the size of the last."""
    cin, cout = 8, 16
    if kind == "dcn_block":
        jm = JaxDeformConvBlock(cout, dtype=jnp.bfloat16, dcn_impl="pallas", dcn_radius=3)
        tm = DeformConv(cin, cout, impl="auto", radius=3)
        xs = [rng.randn(1, 10, 12, cin)]
    elif kind == "tree":
        jm = JaxTree(1, cin, cout, 2, level_root=True, dtype=jnp.bfloat16)
        tm = Tree(1, cin, cout, 2, level_root=True)
        xs = [np.maximum(rng.randn(1, 12, 16, cin), 0)]
    elif kind == "bilinear_up":
        jm = JaxBilinearUp(2, dtype=jnp.bfloat16)
        tm = bilinear_up(cin, 2)
        xs = [rng.randn(1, 6, 8, cin)]
    elif kind == "ida_up":
        jm = JaxIDAUp(cin, [1, 2], dtype=jnp.bfloat16, dcn_impl="pallas", dcn_radius=3)
        tm = IDAUp(cin, [cin, cout], [1, 2], "auto", 3)
        xs = [np.maximum(rng.randn(1, 12, 16, cin), 0), np.maximum(rng.randn(1, 6, 8, cout), 0)]
    else:
        chans = [cin, cout, 2 * cout]
        jm = JaxDLAUp(0, chans, [1, 2, 4], dtype=jnp.bfloat16, dcn_impl="pallas", dcn_radius=3)
        tm = DLAUp(chans, [1, 2, 4], "auto", 3)
        xs = [np.maximum(rng.randn(1, 12 >> i, 16 >> i, c), 0) for i, c in enumerate(chans)]
    return jm, tm, [_bf16(x) for x in xs]


def _args(kind, xs):
    """A block's arguments, as its parent passes them."""
    if kind == "ida_up":
        return (xs, 0, len(xs))
    return (xs,) if kind == "dla_up" else (xs[0],)


def _outputs(kind, out):
    """A block's outputs as a list: IDAUp's merged level, DLAUp's levels."""
    if kind == "ida_up":
        return list(out[-1:])
    return list(out) if kind == "dla_up" else [out]


@pytest.mark.parametrize("kind", ["dcn_block", "tree", "bilinear_up", "ida_up", "dla_up"])
def test_bf16_block_matches_jax(kind):
    """A DCN block (DCN + BN + ReLU; the JAX side through the Pallas kernel,
    which takes fp32 offsets), a level of the DLA trunk, the bilinear
    upsampling, an IDAUp (projection, upsampling and node) and a DLAUp of
    three levels (every output level), each in bf16 on the same input."""
    rng = np.random.RandomState(41)
    jm, tm, xs = _block(kind, rng)
    kwargs = {} if kind == "bilinear_up" else {"train": False}
    shapes = jax.eval_shape(lambda r: jm.init(r, *_args(kind, xs), **kwargs), jax.random.PRNGKey(0))
    variables = _draw(shapes, rng)
    want = _outputs(kind, jax.jit(lambda v, a: jm.apply(v, *_args(kind, a), **kwargs))(
        variables, [jnp.asarray(x, jnp.bfloat16) for x in xs]))
    if kind == "bilinear_up":  # a bare kernel (2f, 2f, 1, C) -> (C, 1, 2f, 2f)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(np.transpose(variables["params"]["kernel"], (3, 2, 0, 1))))
    else:
        _load(tm, variables, small_configs()[1])
    with torch.no_grad():
        got = _outputs(kind, tm(*_args(kind, [torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2)
                                               for x in xs])))
    if kind == "dcn_block":
        with torch.no_grad():
            off = tm.conv.conv_offset_mask(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))[:, :18]
        assert 0.3 < float(off.abs().max()) < 3.0  # the samples move, inside the clamp
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, (kind, i)
        _close(g.float().permute(0, 2, 3, 1).numpy(), np.asarray(w, np.float32), f"{kind} output {i}")


# ------------------------------------------------------------ end to end


def test_bf16_forward_end_to_end(monkeypatch):
    """``build_detector`` with fp16: parameters stay fp32, every DCN gets fp32
    offsets and bf16 x, mask, weight and bias (what the kernel takes), and
    ``infer`` returns finite fp32 rows."""
    _, tcfg = small_configs()
    tcfg = _fp16(dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, backbone=dataclasses.replace(tcfg.model.backbone, dcn_impl="auto"))))
    model = build_detector(tcfg, device="cpu", seed=3)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    plain = dcn_cuda.deform_conv2d_clamped

    def spy(x, offset, mask, weight, bias, radius):
        seen.append((x.dtype, offset.dtype, mask.dtype, weight.dtype, bias.dtype))
        return plain(x, offset, mask, weight, bias, radius)

    monkeypatch.setattr(dcn_cuda, "deform_conv2d_clamped", spy)
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randn(B, tcfg.input.height_train, tcfg.input.width_train, 3)
                              .astype(np.float32))
    ei, el = edge_inputs(tcfg, B, rng)
    calib = torch.from_numpy(np.tile(KITTI_P2[None], (B, 1, 1)).astype(np.float32))
    pad = torch.tensor([[4.0, 2.0]] * B)
    size = torch.tensor([[120.0, 60.0]] * B)
    out = infer(model, images, torch.from_numpy(ei).long(), torch.from_numpy(el).long(),
                calib, pad, size)
    bf = torch.bfloat16
    assert seen == [(bf, torch.float32, bf, bf, bf)] * 16
    assert out["dets"].dtype == torch.float32 and out["dets"].shape == (B, 50, 14)
    assert bool(torch.isfinite(out["dets"]).all())


# ------------------------------------------------ whole forward against JAX


def _forced_blocks(model):
    """{port module name: (kind, JAX intermediate path)} of every block of
    the backbone: the trunk's stem convs, each BasicBlock, Root and Tree
    projection, and each DCN block and upsampling of DLAUp and the final
    IDAUp."""
    out = {}
    for name, m in model.backbone.named_modules():
        parts = name.split(".")
        if name in ("base.base_layer", "base.level0", "base.level1"):
            kind = "stem"
            if parts[-1] != "base_layer":  # JAX names each of the level's convs
                parts[-1] = f"{parts[-1]}_{len(m) // 3 - 1}"
        elif parts[-1] == "project":
            kind, parts[-1] = "project", "project_bn"
        elif type(m).__name__ in ("BasicBlock", "Root", "DeformConv"):
            kind = type(m).__name__
        elif isinstance(m, torch.nn.ConvTranspose2d):
            kind = "up"
        else:
            continue
        out["backbone." + name] = (kind, ("backbone", *parts))
    return out


def _intermediate(tree, path):
    for key in path:
        tree = tree[key]
    return tree["__call__"][0]


def _numpy(out):
    return {k: np.asarray(v, np.float32) if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def whole():
    """The small detector's whole bf16 forward in both packages, on
    tests/test_torch_model.py's calibrated weights and inputs; the JAX side
    samples through the Pallas kernel, with fp32 offsets as on the TPU and
    in the port. Free-running in both packages; in the port once more with
    each backbone block's output replaced by JAX's (so that every block is
    fed JAX's input of it, in its place in the forward); and the JAX fp32
    forward."""
    jcfg, tcfg = small_configs()
    rng = np.random.RandomState(11)
    images = rng.randn(B, jcfg.input.height_train, jcfg.input.width_train, 3).astype(np.float32)
    ei, el = edge_inputs(jcfg, B, rng)
    _, variables = calibrated_variables(jcfg, tcfg, images, ei, el, seed=2)
    args_j = (jnp.asarray(images), jnp.asarray(ei), jnp.asarray(el))

    def jax_forward(cfg, dtype, capture):
        model = JaxDetector(cfg, dtype=dtype)
        return jax.jit(lambda v, *a: model.apply(v, *a, train=False, lazy_topk=True,
                                                 capture_intermediates=capture))(variables, *args_j)

    out16, state16 = jax_forward(with_dcn(jcfg, "pallas"), jnp.bfloat16, True)
    inter16 = state16["intermediates"]
    out32, state32 = jax_forward(jcfg, jnp.float32, lambda mdl, _: isinstance(mdl, JaxDLASeg))

    cfg16 = _fp16(tcfg)
    model = KeypointDetector(cfg16).eval()
    load_state(model, from_jax_variables(variables, cfg16))
    args_t = (torch.from_numpy(images), torch.from_numpy(ei).long(), torch.from_numpy(el).long())
    with torch.no_grad():
        free = model(*args_t, lazy_topk=True)
        free_feat = model.backbone(args_t[0].bfloat16().permute(0, 3, 1, 2))

    blocks, got = _forced_blocks(model), {}
    mods = dict(model.named_modules())

    def force(name, want):
        def hook(_m, _i, out):
            got[name] = out
            return torch.from_numpy(np.asarray(want, np.float32)).permute(0, 3, 1, 2).to(out.dtype)
        return hook

    hooks = [mods[n].register_forward_hook(force(n, _intermediate(inter16, path)))
             for n, (_, path) in blocks.items()]
    with torch.no_grad():
        forced = model(*args_t, lazy_topk=True)
    for h in hooks:
        h.remove()

    tensors = lambda out: {k: v.float().numpy() for k, v in out.items()}
    return dict(cfg=tcfg, blocks=blocks, got=got, inter16=inter16, jax16=_numpy(out16),
                jax32=_numpy(out32), forced=tensors(forced), free=tensors(free),
                feat16=np.asarray(_intermediate(inter16, ("backbone",)), np.float32),
                feat32=np.asarray(_intermediate(state32["intermediates"], ("backbone",)), np.float32),
                free_feat=free_feat.float().permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("kind", ["stem", "BasicBlock", "Root", "project", "DeformConv", "up"])
def test_bf16_forward_block_by_block_matches_jax(whole, kind):
    """Every block of the bf16 backbone, in its place in the whole forward
    and fed JAX's input of it: the port's output has JAX's type and is
    within 2e-2 of JAX's output's largest magnitude."""
    names = [n for n, (k, _) in whole["blocks"].items() if k == kind]
    assert len(names) == {"DeformConv": 16, "stem": 3}.get(kind, len(names)) > 0
    for name in names:
        want = _intermediate(whole["inter16"], whole["blocks"][name][1])
        got = whole["got"][name]
        assert (got.dtype, want.dtype) == (torch.bfloat16, jnp.bfloat16), name
        _close(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32), name)


def test_bf16_forward_heads_match_jax(whole):
    """The heads of the block-by-block forward (fed the backbone feature of
    JAX's whole bf16 forward) against JAX's whole bf16 forward: the heatmap,
    and every regression head at the peaks both chose."""
    pair = dict(out_t={k: torch.from_numpy(v) for k, v in whole["forced"].items()},
                out_j=whole["jax16"])
    _close(whole["forced"]["cls"], whole["jax16"]["cls"], "cls")
    b, it, ij = _matched(pair)
    head = whole["cfg"].model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    for key, _ in head.reg_channels_flat:
        sl = k2c(key)
        _close(whole["forced"]["reg_pois"][b, it, sl], whole["jax16"]["reg_pois"][b, ij, sl], key)


def _gaps(got, want, feat_got, feat_want, cfg):
    """Relative RMS difference ||got - want|| / ||want|| of the backbone
    feature, the heatmap and each regression head at the peaks both chose."""
    rms = lambda g, w: float(np.linalg.norm(g - w) / np.linalg.norm(w))
    out = {"feature": rms(feat_got, feat_want), "cls": rms(got["cls"], want["cls"])}
    rows = [(b, i, j) for b in range(B) for j, p in enumerate(want["points_xy"][b])
            for i in np.nonzero((got["points_xy"][b] == p).all(-1))[0][:1]]
    b, ig, iw = (np.array(x) for x in zip(*rows))
    head = cfg.model.head
    k2c = Converter_key2channel(head.regression_heads, head.regression_channels)
    for key, _ in head.reg_channels_flat:
        out[key] = rms(got["reg_pois"][b, ig, k2c(key)], want["reg_pois"][b, iw, k2c(key)])
    return out


def test_bf16_whole_forward_gap_is_the_precisions_own(whole):
    """Free-running, the whole bf16 forward of this randomly drawn detector
    parts from the fp32 one far beyond 2e-2 in JAX itself: one flipped bf16
    rounding grows through the calibrated layers into an unrelated one. The
    port's bf16 forward may be no further from JAX's than two bf16 forwards
    that part from the fp32 one independently would be from each other:
    sqrt(2) times JAX's own bf16-vs-fp32 difference, output by output."""
    own = _gaps(whole["jax16"], whole["jax32"], whole["feat16"], whole["feat32"], whole["cfg"])
    port = _gaps(whole["free"], whole["jax16"], whole["free_feat"], whole["feat16"], whole["cfg"])
    assert own["feature"] > 10 * TOL, own
    worse = {k: (port[k], own[k]) for k in own if not port[k] <= np.sqrt(2) * own[k]}
    assert not worse, worse
