"""The port's detector ops against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``crct_tpu.ops``
(``nms``, ``roi_align``, ``roi_align_pallas`` in interpret mode) and
``crct_tpu.detector.boxes``, and through their counterparts in
``crct_tpu_torch``:

  * NMS, fast NMS and batched NMS: equal indices and validity. The inputs
    keep every score distinct and every pairwise IoU at least 1e-3 away
    from the threshold (checked in the test), so no choice sits on a tie;
  * RoIAlign and the multilevel forward: within 1e-5;
  * the einsum backward against ``_mlra_backward``, and K3's plain version
    against ``_mlra_backward`` and ``mlra_backward_pallas(interpret=True)``
    (N = 37/12/64, P = 7 and 14, wide, tall and tiny chart boxes): within
    2e-5 of max(1, |grad|) in fp32 (the sums run in other orders), 1e-2 of
    it with bf16 maps and cotangents (one bf16 rounding of the output);
  * the autograd backward running K3's wrapper on the forward's geometry;
  * each roi's footprint (its first lo and last hi corner on each axis),
    on which K3's tiles skip rois, against the JAX backward's ymin / ymax,
    and K3's plain version against ``_mlra_backward`` at an odd canvas
    (800 x 1216) with border, zero-area and one-level boxes (fp32, 2e-5 of
    max(1, |grad|));
  * anchors, delta coding, matching and the fixed sampler (with the JAX
    noise handed in through the port's one draw function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.detector import boxes as jax_boxes
from crct_tpu.ops import nms as jax_nms
from crct_tpu.ops import roi_align as jax_ra
from crct_tpu.ops.roi_align_pallas import mlra_backward_pallas
from crct_tpu_torch.detector import boxes
from crct_tpu_torch.ops import nms, roi_align, roi_align_kernel

STRIDES = (4, 8, 16, 32)
H, W, C = 80, 104, 64
ARGS = (STRIDES, None, 2, 4, 224, 2, 5)        # output_size filled per case


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol):
    """max |got - want| <= rtol * max(1, |want|), level by level."""
    for lvl, (a, b) in enumerate(zip(got, want)):
        a = np.asarray(a.float() if isinstance(a, torch.Tensor) else
                       np.asarray(a, np.float32), np.float32)
        b = np.asarray(b.float() if isinstance(b, torch.Tensor) else
                       np.asarray(b, np.float32), np.float32)
        scale = max(float(np.abs(b).max()), 1.0)
        assert np.abs(a - b).max() <= rtol * scale, \
            f"level {lvl}: {np.abs(a - b).max():.2e} vs scale {scale:.1f}"


def args(p):
    return (STRIDES, p) + ARGS[2:]


def port_backward(fn, feats, b, g, p):
    """A backward route of the port (fn: the einsum VJP, K3's wrapper or
    its plain version) on the geometry of boxes b, as the forward hands it
    over."""
    shapes = roi_align.level_shapes(feats)
    geo = roi_align.mlra_geometry(shapes, b, *args(p))
    return fn(g, geo, shapes, feats[0].dtype, 2)


@pytest.fixture(scope="module")
def feats_np():
    r = np.random.default_rng(3)
    return [r.random((H // s, W // s, C), np.float32) for s in STRIDES]


def chart_boxes(n, seed=0):
    """Random boxes plus chart elements: a wide axis title, a tall thin
    bar, a tiny tick, and a whole-figure box (past the map's edge) on the
    coarsest level."""
    r = np.random.default_rng(seed)
    raw = np.sort(r.random((n, 2, 2), np.float32), axis=1)
    b = np.concatenate([raw[:, 0] * [W * 4, H * 4],
                        raw[:, 1] * [W * 4, H * 4]], axis=1)
    b[0] = [1, 1, 300, 9]
    b[1] = [2, 5, 10, 310]
    b[2] = [0, 0, 2, 2]
    b[3] = [3, 2, 590, 470]
    return b.astype(np.float32)


CASES = [(37, 7), (12, 14), (64, 7)]
# the interpret-mode Pallas kernel takes ~12 s a call here at P = 7 and
# ~22 s at P = 14: it runs at one case; the einsum VJP, which
# tests/test_roi_align_pallas.py holds equal to it at both P, at every case
PALLAS_CASES = [(37, 7)]


# jitted: op by op, the einsum VJP takes ~6 s a call here
_jax_mlra_backward = jax.jit(jax_ra._mlra_backward,
                             static_argnums=(3, 4, 5, 6, 7, 8, 9))


_jax_sample_fixed = jax.jit(jax_boxes.sample_fixed,
                            static_argnames=("num", "pos_fraction"))


@pytest.fixture(scope="module")
def jax_backward(feats_np):
    """Per case: boxes, cotangent, the einsum VJP and (where run) the
    interpret-mode Pallas kernel, computed once."""
    feats = tuple(jnp.asarray(f) for f in feats_np)
    out = {}
    for n, p in CASES:
        b = chart_boxes(n)
        g = np.random.default_rng(7).random((n, p, p, C), np.float32)
        pallas = (mlra_backward_pallas(feats, jnp.asarray(b), jnp.asarray(g),
                                       *args(p), interpret=True)
                  if (n, p) in PALLAS_CASES else None)
        out[(n, p)] = (b, g,
                       _jax_mlra_backward(feats, jnp.asarray(b),
                                          jnp.asarray(g), *args(p)),
                       pallas)
    return out


def spread_boxes(n, seed):
    """Boxes with distinct scores and no IoU within 1e-3 of 0.3/0.4/0.5."""
    rng = np.random.default_rng(seed)
    centers = rng.random((n, 2)) * 60
    sizes = rng.random((n, 2)) * 20 + 4
    b = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                       axis=1).astype(np.float32)
    s = rng.permutation(n).astype(np.float32) / n + 0.01
    ious = np.asarray(jax_nms.iou_matrix(b, b))
    for thr in (0.3, 0.4, 0.5):
        assert np.abs(ious - thr).min() > 1e-3
    return b, s


@pytest.mark.parametrize("fn", ["nms", "fast_nms", "batched_nms"])
def test_nms_matches_jax(fn):
    b, s = spread_boxes(48, 2)
    kw = dict(iou_threshold=0.4, score_threshold=0.1, max_outputs=48)
    if fn == "batched_nms":
        cls = np.random.default_rng(5).integers(0, 3, len(b)).astype(np.int32)
        want = jax_nms.batched_nms(b, s, cls, **kw)
        got = nms.batched_nms(t(b), t(s), t(cls), **kw)
    else:
        want = getattr(jax_nms, fn)(b, s, **kw)
        got = getattr(nms, fn)(t(b), t(s), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1].all()


def test_iou_and_top_k_match_jax():
    b, s = spread_boxes(20, 4)
    np.testing.assert_allclose(nms.iou_matrix(t(b), t(b[:7])).numpy(),
                               np.asarray(jax_nms.iou_matrix(b, b[:7])),
                               rtol=1e-6, atol=1e-7)
    tied = np.asarray([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
    idx, vals = nms.top_k_boxes(t(tied), 4)
    want_idx, want_vals = jax_nms.top_k_boxes(tied, 4)
    # ties go to the lowest index, as jax.lax.top_k breaks them
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_roi_align_and_multilevel_forward_match_jax(feats_np):
    feat = feats_np[0]
    b = chart_boxes(9, seed=1) / 4
    want = jax_ra.roi_align(feat, b, spatial_scale=0.25, output_size=5,
                            sampling_ratio=2)
    got = roi_align.roi_align(t(feat), t(b), spatial_scale=0.25,
                              output_size=5, sampling_ratio=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    b = chart_boxes(37)
    for p in (7, 14):
        want = jax_ra.multilevel_roi_align(feats_np, b, output_size=p)
        got = roi_align.multilevel_roi_align([t(f) for f in feats_np], t(b),
                                             output_size=p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # every level is hit
    geo = roi_align.mlra_geometry(roi_align.level_shapes(
        [t(f) for f in feats_np]), t(b), *args(7))
    assert set(geo["lvl"].tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("n,p", CASES)
def test_backwards_match_jax(feats_np, jax_backward, n, p):
    """The einsum VJP and K3's plain version against _mlra_backward and the
    interpret-mode Pallas kernel (fp32, tolerance 2e-5 of max(1, |grad|))."""
    b, g, want_einsum, want_pallas = jax_backward[(n, p)]
    feats = [t(f) for f in feats_np]
    einsum = port_backward(roi_align._mlra_backward, feats, t(b), t(g), p)
    plain = port_backward(roi_align_kernel.mlra_backward_reference, feats,
                          t(b), t(g), p)
    # on CPU tensors the kernel's wrapper runs the plain version
    wrapped = port_backward(roi_align_kernel.mlra_backward_kernel, feats,
                            t(b), t(g), p)
    close(einsum, want_einsum, 2e-5)
    close(plain, want_einsum, 2e-5)
    if want_pallas is not None:
        close(plain, want_pallas, 2e-5)
    for a, w in zip(wrapped, plain):
        assert a.shape == w.shape and torch.equal(a, w)


def test_bf16_backward_matches_jax(feats_np):
    """bf16 maps and cotangent: gradients in bf16, within 1e-2 of
    max(1, |grad|) of the JAX einsum VJP (the Pallas kernel's bf16 case is
    held to it in tests/test_roi_align_pallas.py)."""
    b = chart_boxes(16)
    g = np.random.default_rng(9).random((16, 7, 7, C), np.float32)
    f16 = tuple(jnp.asarray(f).astype(jnp.bfloat16) for f in feats_np)
    g16 = jnp.asarray(g).astype(jnp.bfloat16)
    want = _jax_mlra_backward(f16, jnp.asarray(b), g16, *args(7))
    tf16 = [t(f).to(torch.bfloat16) for f in feats_np]
    tg16 = t(g).to(torch.bfloat16)
    plain = port_backward(roi_align_kernel.mlra_backward_reference, tf16,
                          t(b), tg16, 7)
    einsum = port_backward(roi_align._mlra_backward, tf16, t(b), tg16, 7)
    assert plain[0].dtype == einsum[0].dtype == torch.bfloat16
    close(plain, [np.asarray(x, np.float32) for x in want], 1e-2)
    close(einsum, [np.asarray(x, np.float32) for x in want], 1e-2)


def test_plain_backward_is_the_transpose_of_the_forward(feats_np):
    """K3's plain version equals torch autograd through the forward's
    gather (fp32, 2e-5 of max(1, |grad|))."""
    b = t(chart_boxes(23, seed=4))
    feats = [t(f).requires_grad_() for f in feats_np]
    g = t(np.random.default_rng(2).normal(size=(23, 14, 14, C))
          .astype(np.float32))
    geo = roi_align.mlra_geometry(roi_align.level_shapes(feats), b,
                                  *args(14))
    out = roi_align._mlra_forward(feats, geo, 14, 2)
    auto = torch.autograd.grad(out, feats, g)
    plain = port_backward(roi_align_kernel.mlra_backward_reference, feats, b,
                          g, 14)
    close(plain, auto, 2e-5)


def test_autograd_backward_runs_the_kernel_wrapper(feats_np, monkeypatch):
    """The autograd backward goes through mlra_backward_kernel (a spy sees
    it) on the geometry the forward computed (computed once), and matches
    the einsum VJP put in its place; boxes get a zero gradient."""
    b = t(chart_boxes(11)).requires_grad_()

    def grads():
        feats = [t(f).requires_grad_() for f in feats_np]
        out = roi_align.multilevel_roi_align(feats, b, strides=STRIDES,
                                             output_size=7)
        return torch.autograd.grad((out * out).sum(), feats + [b])

    calls, geometries = [], []
    real_geometry = roi_align.mlra_geometry
    real = roi_align_kernel.mlra_backward_kernel

    def geometry(*a):
        geometries.append(real_geometry(*a))
        return geometries[-1]

    def spy(g, geo, *a):
        calls.append((g.shape, geo))
        return real(g, geo, *a)

    monkeypatch.setattr(roi_align, "mlra_geometry", geometry)
    monkeypatch.setattr(roi_align_kernel, "mlra_backward_kernel", spy)
    got = grads()
    assert len(calls) == len(geometries) == 1
    assert calls[0][0] == (11, 7, 7, C)
    assert all(calls[0][1][k].data_ptr() == v.data_ptr()
               for k, v in geometries[0].items())
    monkeypatch.setattr(roi_align_kernel, "mlra_backward_kernel",
                        roi_align._mlra_backward)
    want = grads()
    close(got[:4], want[:4], 2e-5)
    assert not got[4].any() and not want[4].any()


ODD_SHAPES = [(200, 304), (100, 152), (50, 76), (25, 38)]   # 800 x 1216


def odd_canvas_boxes(case):
    """Boxes on the 800 x 1216 canvas: on and past its border (clamped
    corners, lo == hi at the last row or column), of zero area (every
    sample of an axis on one position), or all on one level."""
    r = np.random.default_rng(17)
    if case == "border":
        b = [[-10, -10, 60, 30], [1180, 770, 1230, 810], [0, 0, 1216, 800],
             [-40, 300, 1300, 360], [1100, -20, 1216, 800],
             [1215.5, 5, 1216, 790], [3, 795, 400, 800]]
    elif case == "zero_area":
        b = [[500, 300, 500, 300], [0, 0, 0, 0], [1216, 800, 1216, 800],
             [100, 200, 100, 600], [300, 700, 900, 700],
             [1215.9, 799.9, 1215.9, 799.9]]
    elif case == "one_level":
        xy = r.random((12, 2)) * [1000, 600]
        b = np.concatenate([xy, xy + r.uniform(130, 200, (12, 2))], 1)
    else:
        raise ValueError(case)
    return np.asarray(b, np.float32)


FOOTPRINT_CASES = {"chart": lambda: ([(H // s, W // s) for s in STRIDES],
                                     chart_boxes(37)),
                   **{c: (lambda c=c: (ODD_SHAPES, odd_canvas_boxes(c)))
                      for c in ("border", "zero_area", "one_level")}}


@pytest.mark.parametrize("case", list(FOOTPRINT_CASES))
@pytest.mark.parametrize("p", [7, 14])
def test_roi_footprint_is_the_jax_backwards_extent(case, p):
    """The footprint K3's tiles test a roi by, [y0[:, 0], y1i[:, -1]] x
    [x0[:, 0], x1i[:, -1]] of the port's mlra_geometry, equals the JAX
    backward's ymin / ymax (the min of y0, the max of y1i over the samples;
    the same for x) from crct_tpu.ops.roi_align._mlra_geometry; it holds
    every sample corner; and the plain backward is zero outside the union
    of the footprints on each level: a tile no footprint meets may store
    zeros."""
    shapes, b = FOOTPRINT_CASES[case]()
    geo = roi_align.mlra_geometry(shapes, t(b), *args(p))
    jgeo = jax_ra._mlra_geometry([np.zeros((h, w, 1), np.float32)
                                  for h, w in shapes], jnp.asarray(b),
                                 *args(p))
    lvl = geo["lvl"].numpy()
    np.testing.assert_array_equal(lvl, np.asarray(jgeo["lvl"]))
    for lo, hi in (("y0", "y1i"), ("x0", "x1i")):
        first, last = geo[lo][:, 0].numpy(), geo[hi][:, -1].numpy()
        np.testing.assert_array_equal(first, np.asarray(jgeo[lo]).min(1))
        np.testing.assert_array_equal(last, np.asarray(jgeo[hi]).max(1))
        for k in (lo, hi):
            assert (geo[k].numpy() >= first[:, None]).all()
            assert (geo[k].numpy() <= last[:, None]).all()
    g = t(np.random.default_rng(5).normal(size=(len(b), p, p, 8))
          .astype(np.float32))
    grads = roi_align_kernel.mlra_backward_reference(g, geo, shapes,
                                                     torch.float32, 2)
    for lv, (grad, (h, w)) in enumerate(zip(grads, shapes)):
        inside = torch.zeros(h, w, dtype=torch.bool)
        for n in np.flatnonzero(lvl == lv):
            inside[geo["y0"][n, 0]:geo["y1i"][n, -1] + 1,
                   geo["x0"][n, 0]:geo["x1i"][n, -1] + 1] = True
        assert not grad[~inside].any(), f"level {lv}"
        assert grad[inside].any() or not (lvl == lv).any()


@pytest.mark.parametrize("case", ["border", "zero_area", "one_level"])
def test_plain_backward_matches_jax_at_an_odd_canvas(case):
    """K3's plain version against the JAX einsum VJP at the 800 x 1216
    canvas, whose levels 200 x 304 ... 25 x 38 end in partial tiles (fp32,
    2e-5 of max(1, |grad|): the sums run in other orders)."""
    b = odd_canvas_boxes(case)
    g = np.random.default_rng(6).normal(size=(len(b), 7, 7, 8)) \
        .astype(np.float32)
    feats = [np.zeros((h, w, 8), np.float32) for h, w in ODD_SHAPES]
    want = _jax_mlra_backward(tuple(jnp.asarray(f) for f in feats),
                              jnp.asarray(b), jnp.asarray(g), *args(7))
    geo = roi_align.mlra_geometry(ODD_SHAPES, t(b), *args(7))
    if case == "one_level":
        assert len(set(geo["lvl"].tolist())) == 1
    got = roi_align_kernel.mlra_backward_reference(t(g), geo, ODD_SHAPES,
                                                   torch.float32, 2)
    close(got, want, 2e-5)
    assert any(x.any() for x in got)


def test_anchors_and_delta_coding_match_jax():
    np.testing.assert_array_equal(
        boxes.generate_anchors((5, 7), 8, [32]),
        jax_boxes.generate_anchors((5, 7), 8, [32]))
    rng = np.random.default_rng(0)
    anchors = boxes.generate_anchors((4, 4), 16, [64])
    raw = np.sort(rng.random((len(anchors), 2, 2)) * 64, axis=1)
    gt = np.concatenate([raw[:, 0], raw[:, 1]], -1).astype(np.float32)
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        enc = boxes.encode_deltas(t(gt), t(anchors), w)
        np.testing.assert_allclose(
            enc.numpy(), np.asarray(jax_boxes.encode_deltas(
                jnp.asarray(gt), jnp.asarray(anchors), w)), atol=1e-5)
        dec = boxes.decode_deltas(enc * 3, t(anchors), w)
        np.testing.assert_allclose(
            dec.numpy(), np.asarray(jax_boxes.decode_deltas(
                jnp.asarray(enc.numpy() * 3), jnp.asarray(anchors), w)),
            rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        boxes.clip_boxes(t(gt * 2 - 20), 50, 60).numpy(),
        np.asarray(jax_boxes.clip_boxes(jnp.asarray(gt * 2 - 20), 50, 60)))


def test_match_and_sample_match_jax(monkeypatch):
    """Matching (with padding GTs whose argmax lands on anchor 0) and the
    fixed sampler fed the JAX noise. IoUs sit 1e-3 clear of 0.3 and 0.7."""
    anchors = boxes.generate_anchors((8, 8), 8, [24])
    gt = np.asarray([[3.7, 2.9, 26.1, 29.1], [30.2, 11.4, 59.3, 22.6],
                     [8.1, 40.5, 21.2, 61.3], [0, 0, 0, 0], [0, 0, 0, 0]],
                    np.float32)
    valid = np.asarray([True, True, True, False, False])
    ious = np.asarray(jax_nms.iou_matrix(anchors, gt[:3]))
    assert np.abs(ious - 0.3).min() > 1e-3 and np.abs(ious - 0.7).min() > 1e-3
    want = jax_boxes.match_anchors(jnp.asarray(anchors), jnp.asarray(gt),
                                   jnp.asarray(valid), pos_thr=0.7,
                                   neg_thr=0.3)
    got = boxes.match_anchors(t(anchors), t(gt), t(valid), pos_thr=0.7,
                              neg_thr=0.3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    label = got[1]
    assert (label == 1).sum() >= 3

    key = jax.random.key(4)
    noise = np.asarray(jax.random.uniform(key, (label.shape[0],)))
    monkeypatch.setattr(boxes, "_draw_uniform",
                        lambda gen, n, dev: t(noise[:n]))
    for num, frac in ((32, 0.25), (16, 0.5)):
        idx, w = boxes.sample_fixed(label, None, num=num, pos_fraction=frac)
        want_idx, want_w = _jax_sample_fixed(
            jnp.asarray(label.numpy()), key, num=num, pos_fraction=frac)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
