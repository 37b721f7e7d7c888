"""The A9 tables: the recurrent layers' cases, the detection ops' cases
and the user programs built on them, for either package.

``RNN_CASES`` (:class:`LayerCase`) covers every class of ``nn/rnn.py``:
the three cells, ``RNN`` over each, the stacked ``SimpleRNN``, ``LSTM``
and ``GRU`` and ``BiRNN``, with ``sequence_length`` forward, reverse and
bidirectional, ``time_major``, initial states and a cell of the user's
own. ``DET_CASES`` (:class:`OpCase`) covers the detection ops of
``ops/detection.py`` that the YOLOv3 paths did not (``prior_box`` to
``matrix_nms``), ``roi_align`` at ``sampling_ratio`` -1, 0 and 2, with
rois across the border and bins past the 8-tap cap. :func:`lstm_lm` is
the LSTM language model (PTB-large at its defaults); :func:`rpn_to_rois`,
:func:`roi_features` and :func:`detect` are the Faster R-CNN chain from
the RPN's outputs to the final detections at ``FRCNN``'s settings, and
:func:`frcnn_inputs` seeded inputs for it at a small size. ``test_torch_rnn.py`` and
``test_torch_detection_a9.py`` hold them against the JAX package on the
CPU; ``test_torch_cuda.py`` and ``chip_smoke.py`` (phases 27 and 28)
hold them on the card against the CPU.

This module imports neither jax nor the JAX package.
"""
import numpy as np

from test_torch_op_table import _A, _F, _I, LayerCase, OpCase

# -- the recurrent layers -------------------------------------------------------

T, B, IN, HID = 5, 3, 4, 6
LENS = [5, 3, 1]                   # a full row, a partial one, one step


def _lens(rng):
    return np.asarray(LENS, np.int64)


def _custom_cell(m):
    """A cell of the user's own (none of the three kinds): the
    reference's scan runs it through the simple-RNN body."""
    class Cell(m.nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.input_size, self.hidden_size = IN, HID
            init = m.nn.initializer.Uniform(-0.3, 0.3)
            self.weight_ih = self.create_parameter(
                [HID, IN], default_initializer=init)
            self.weight_hh = self.create_parameter(
                [HID, HID], default_initializer=init)
            self.bias_ih = self.create_parameter(
                [HID], is_bias=True, default_initializer=init)
            self.bias_hh = self.create_parameter(
                [HID], is_bias=True, default_initializer=init)
    return Cell()


def _rnn_cases():
    L = LayerCase
    x, xt, h, lens = _F(B, T, IN), _F(T, B, IN), _F(B, HID), _lens
    nn = lambda m: m.nn  # noqa: E731
    seq = lambda layer, x, n: layer(x, None, n)  # noqa: E731
    return [
        L("SimpleRNNCell_tanh", lambda m: nn(m).SimpleRNNCell(IN, HID),
          [_F(B, IN), h]),
        L("SimpleRNNCell_relu_zero_state", lambda m: nn(m).SimpleRNNCell(
            IN, HID, activation="relu"), [_F(B, IN)]),
        L("LSTMCell", lambda m: nn(m).LSTMCell(IN, HID),
          [_F(B, IN), h, h], call=lambda c, x, h, s: c(x, (h, s))),
        L("LSTMCell_zero_state", lambda m: nn(m).LSTMCell(IN, HID),
          [_F(B, IN)]),
        L("GRUCell", lambda m: nn(m).GRUCell(IN, HID), [_F(B, IN), h]),
        L("RNN_lstm_seq_len", lambda m: nn(m).RNN(nn(m).LSTMCell(IN, HID)),
          [x, lens], call=seq),
        L("RNN_gru_reverse_seq_len_init", lambda m: nn(m).RNN(
            nn(m).GRUCell(IN, HID), is_reverse=True), [x, lens, h],
          call=lambda r, x, n, s: r(x, s, n)),
        L("RNN_simple_reverse_time_major", lambda m: nn(m).RNN(
            nn(m).SimpleRNNCell(IN, HID), is_reverse=True, time_major=True),
          [xt]),
        L("RNN_lstm_time_major_init", lambda m: nn(m).RNN(
            nn(m).LSTMCell(IN, HID), time_major=True), [xt, h, h],
          call=lambda r, x, a, b: r(x, (a, b))),
        L("RNN_simple_reverse_seq_len", lambda m: nn(m).RNN(
            nn(m).SimpleRNNCell(IN, HID), is_reverse=True), [x, lens],
          call=seq),
        L("LSTM_2layer_bidirect_seq_len_init", lambda m: nn(m).LSTM(
            IN, HID, num_layers=2, direction="bidirect"),
          [x, lens, _F(4, B, HID), _F(4, B, HID)],
          call=lambda r, x, n, a, b: r(x, (a, b), n)),
        L("LSTM_2layer", lambda m: nn(m).LSTM(IN, HID, num_layers=2), [x]),
        L("LSTM_time_major_seq_len", lambda m: nn(m).LSTM(
            IN, HID, time_major=True), [xt, lens], call=seq),
        L("GRU_2layer_time_major_init", lambda m: nn(m).GRU(
            IN, HID, num_layers=2, time_major=True), [xt, _F(2, B, HID)]),
        L("GRU_bidirect_seq_len", lambda m: nn(m).GRU(
            IN, HID, direction="bidirectional"), [x, lens], call=seq),
        L("SimpleRNN_relu_2layer_bidirect_seq_len", lambda m: nn(m).SimpleRNN(
            IN, HID, num_layers=2, direction="bidirect", activation="relu"),
          [x, lens], call=seq),
        L("SimpleRNN_init", lambda m: nn(m).SimpleRNN(IN, HID),
          [x, _F(1, B, HID)]),
        L("BiRNN_lstm_seq_len", lambda m: nn(m).BiRNN(
            nn(m).LSTMCell(IN, HID), nn(m).LSTMCell(IN, HID)), [x, lens],
          call=seq),
        L("BiRNN_gru_init", lambda m: nn(m).BiRNN(
            nn(m).GRUCell(IN, HID), nn(m).GRUCell(IN, HID)), [x, h, h],
          call=lambda r, x, a, b: r(x, (a, b))),
        L("RNN_custom_cell", lambda m: nn(m).RNN(_custom_cell(m)),
          [x, lens], call=seq),
    ]


RNN_CASES = _rnn_cases()


def lstm_lm(m, vocab=10000, hidden=1500, layers=2, dropout=0.65,
            init_scale=0.04):
    """The LSTM language model of Zaremba, Sutskever & Vinyals 2014
    ("large": vocabulary 10,000, 2 layers of 1,500, dropout 0.65, every
    weight uniform in +-0.04) as a paddle user writes it from package
    ``m``: ``Embedding`` -> ``Dropout`` -> ``LSTM`` -> ``Dropout`` ->
    ``Linear``; returns ``(network, loss)``, the loss the mean cross
    entropy over every position. ``init_scale=None`` keeps the layers'
    own initialisers."""
    nn, F = m.nn, m.nn.functional
    attr = None if init_scale is None else \
        nn.initializer.Uniform(-init_scale, init_scale)

    class LM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(vocab, hidden, weight_attr=attr)
            self.drop_in = nn.Dropout(dropout)
            self.lstm = nn.LSTM(hidden, hidden, num_layers=layers,
                                dropout=dropout, weight_ih_attr=attr,
                                weight_hh_attr=attr, bias_ih_attr=attr,
                                bias_hh_attr=attr)
            self.drop_out = nn.Dropout(dropout)
            self.head = nn.Linear(hidden, vocab, weight_attr=attr,
                                  bias_attr=attr)

        def forward(self, ids):
            y, _ = self.lstm(self.drop_in(self.embed(ids)))
            return self.head(self.drop_out(y))

    class Loss(nn.Layer):
        def forward(self, logits, labels):
            return F.cross_entropy(m.reshape(logits, [-1, vocab]),
                                   m.reshape(labels, [-1]))
    return LM(), Loss()


# -- the detection ops ----------------------------------------------------------

def _boxes(n, lo=0.0, hi=40.0, min_wh=2.0, max_wh=20.0, lead=()):
    """Seeded x1y1x2y2 boxes ``[*lead, n, 4]`` with corners in [lo, hi)."""
    def make(rng):
        xy = rng.uniform(lo, hi, (*lead, n, 2))
        wh = rng.uniform(min_wh, max_wh, (*lead, n, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return make


def _grid_anchors(h, w, sizes, stride):
    """Anchors ``[h, w, len(sizes) * 3, 4]`` at ratios 0.5, 1, 2, as
    ``anchor_generator`` lays them out."""
    def make(rng):
        ws = [s * np.sqrt(1.0 / r) for r in (0.5, 1.0, 2.0) for s in sizes]
        hs = [s * np.sqrt(r) for r in (0.5, 1.0, 2.0) for s in sizes]
        cx = (np.arange(w) + 0.5) * stride
        cy = (np.arange(h) + 0.5) * stride
        ws, hs = np.asarray(ws), np.asarray(hs)
        out = np.stack([
            np.broadcast_to(cx[None, :, None] - ws / 2, (h, w, len(ws))),
            np.broadcast_to(cy[:, None, None] - hs / 2, (h, w, len(ws))),
            np.broadcast_to(cx[None, :, None] + ws / 2, (h, w, len(ws))),
            np.broadcast_to(cy[:, None, None] + hs / 2, (h, w, len(ws)))],
            -1)
        return out.astype(np.float32)
    return make


def _det_cases():
    O = OpCase
    d = "det_a9"
    ops = lambda m: m.ops  # noqa: E731
    var4 = _A([0.1, 0.1, 0.2, 0.2])
    two = np.array([2, 3])
    return [
        O("prior_box", lambda m, f, i: ops(m).prior_box(
            f, i, min_sizes=[4.0, 8.0], max_sizes=[6.0, 12.0],
            aspect_ratios=[2.0, 3.0], flip=True, clip=True),
          [_F(1, 2, 3, 4), _F(1, 3, 12, 16)], d, grad=False),
        O("prior_box_min_max_order", lambda m, f, i: ops(m).prior_box(
            f, i, min_sizes=[4.0], max_sizes=[9.0], aspect_ratios=[2.0],
            steps=(4.0, 5.0), offset=0.3, min_max_aspect_ratios_order=True),
          [_F(1, 2, 3, 4), _F(1, 3, 12, 16)], d, grad=False),
        O("density_prior_box", lambda m, f, i: ops(m).density_prior_box(
            f, i, densities=[2, 1], fixed_sizes=[4.0, 8.0],
            fixed_ratios=[1.0, 2.0], clip=True),
          [_F(1, 2, 3, 4), _F(1, 3, 12, 16)], d, grad=False),
        O("density_prior_box_flat", lambda m, f, i: ops(m).density_prior_box(
            f, i, densities=[3], fixed_sizes=[6.0], fixed_ratios=[1.0],
            steps=(4.0, 4.0), flatten_to_2d=True),
          [_F(1, 2, 3, 4), _F(1, 3, 12, 16)], d, grad=False),
        O("anchor_generator", lambda m, f: ops(m).anchor_generator(
            f, anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
            variances=[0.1, 0.1, 0.2, 0.2], stride=[8.0, 8.0]),
          [_F(1, 2, 3, 4)], d, grad=False),
        O("box_coder_encode", lambda m, p, v, t: ops(m).box_coder(
            p, v, t, code_type="encode_center_size"),
          [_boxes(5), _F(5, 4, lo=0.1, hi=0.3), _boxes(3)], d),
        O("box_coder_encode_pixel", lambda m, p, t: ops(m).box_coder(
            p, None, t, code_type="encode_center_size",
            box_normalized=False), [_boxes(5), _boxes(3)], d),
        O("box_coder_decode", lambda m, p, v, t: ops(m).box_coder(
            p, v, t, code_type="decode_center_size", box_normalized=False),
          [_boxes(6), var4, _F(2, 6, 4, lo=-0.5, hi=0.5)], d),
        O("box_decoder_and_assign", lambda m, p, v, t, s: ops(
            m).box_decoder_and_assign(p, v, t, s, box_clip=1.0),
          [_boxes(6), _F(6, 4, lo=0.1, hi=0.3), _F(6, 12, lo=-1, hi=1.5),
           _F(6, 3, lo=0, hi=1)], d),
        O("generate_proposals", lambda m, s, dl, im, a, v: ops(
            m).generate_proposals(s, dl, im, a, v, pre_nms_top_n=40,
                                  post_nms_top_n=12, nms_thresh=0.5,
                                  min_size=2.0),
          [_F(2, 3, 4, 5), _F(2, 12, 4, 5, lo=-0.5, hi=0.5),
           _A([[30.0, 38.0], [26.0, 40.0]]), _grid_anchors(4, 5, [8.0], 8),
           _F(4, 5, 3, 4, lo=0.1, hi=0.3)], d, grad=False),
        O("generate_proposals_pixel_offset_eta", lambda m, s, dl, im, a, v:
          ops(m).generate_proposals(s, dl, im, a, v, pre_nms_top_n=60,
                                    post_nms_top_n=64, nms_thresh=0.7,
                                    min_size=0.0, eta=0.9,
                                    pixel_offset=True),
          [_F(2, 3, 4, 5), _F(2, 12, 4, 5, lo=-0.5, hi=0.5),
           _A([[30.0, 38.0], [26.0, 40.0]]), _grid_anchors(4, 5, [8.0], 8),
           var4], d, grad=False),
        O("distribute_fpn_proposals", lambda m, r: ops(
            m).distribute_fpn_proposals(r, 2, 5, 4, 224),
          [_boxes(20, hi=600.0, min_wh=4.0, max_wh=700.0)], d),
        O("collect_fpn_proposals", lambda m, a, b, s, t: ops(
            m).collect_fpn_proposals([a, b], [s, t], 7),
          [_boxes(6), _boxes(5), _F(6), _F(5)], d),
        O("roi_align_adaptive", lambda m, x, r: ops(m).roi_align(
            x, r, 3, spatial_scale=0.5, sampling_ratio=-1, rois_num=two),
          [_F(2, 3, 12, 14), _boxes(5, lo=-6.0, hi=24.0, max_wh=16.0)], d),
        O("roi_align_zero_unaligned", lambda m, x, r: ops(m).roi_align(
            x, r, (2, 3), spatial_scale=0.5, sampling_ratio=0,
            aligned=False), [_F(1, 3, 12, 14), _boxes(4, hi=24.0)], d),
        O("roi_align_ratio2_border", lambda m, x, r: ops(m).roi_align(
            x, r, 2, sampling_ratio=2, rois_num=two),
          [_F(2, 2, 8, 9), _boxes(5, lo=-4.0, hi=8.0, max_wh=6.0)], d),
        O("roi_align_past_tap_cap", lambda m, x, r: ops(m).roi_align(
            x, r, 2, sampling_ratio=-1),
          [_F(1, 2, 40, 36), _boxes(3, lo=0.0, hi=4.0, min_wh=30.0,
                                    max_wh=36.0)], d),
        O("roi_pool", lambda m, x, r: ops(m).roi_pool(
            x, r, (3, 2), spatial_scale=0.5, rois_num=two),
          [_F(2, 3, 12, 14), _boxes(5, hi=24.0)], d),
        O("psroi_pool", lambda m, x, r: ops(m).psroi_pool(
            x, r, 2, 0.5, 2, 3, rois_num=two),
          [_F(2, 12, 10, 12, lo=0, hi=1), _boxes(5, hi=18.0)], d),
        O("prroi_pool", lambda m, x, r: ops(m).prroi_pool(
            x, r, 3, 2, spatial_scale=0.5, rois_num=two),
          [_F(2, 3, 10, 12), _boxes(5, hi=18.0)], d),
        O("deformable_psroi_pooling", lambda m, x, r, t: ops(
            m).deformable_psroi_pooling(
            x, r, t, spatial_scale=0.5, group_size=2, pooled_height=2,
            pooled_width=2, part_size=2, sample_per_part=2, trans_std=0.1,
            rois_num=two),
          [_F(2, 8, 10, 12), _boxes(5, hi=18.0), _F(5, 2, 2, 2)], d),
        O("deformable_psroi_pooling_no_trans", lambda m, x, r: ops(
            m).deformable_psroi_pooling(
            x, r, None, no_trans=True, spatial_scale=0.5, group_size=1,
            pooled_height=3, pooled_width=2, part_size=3,
            sample_per_part=3), [_F(1, 2, 10, 12), _boxes(4, hi=18.0)], d),
        O("matrix_nms_linear", lambda m, b, s: ops(m).matrix_nms(
            b, s, score_threshold=0.1, post_threshold=0.05, nms_top_k=6,
            keep_top_k=8, normalized=False, return_index=True),
          [_boxes(7, lead=(2,)), _F(2, 3, 7, lo=0, hi=1)], d, grad=False),
        O("matrix_nms_gaussian", lambda m, b, s: ops(m).matrix_nms(
            b, s, score_threshold=0.2, nms_top_k=10, keep_top_k=30,
            use_gaussian=True, gaussian_sigma=0.5, background_label=-1,
            normalized=False),
          [_boxes(7, lead=(2,)), _F(2, 2, 7, lo=0, hi=1)], d, grad=False),
        O("bipartite_match", lambda m, x: ops(m).bipartite_match(x),
          [_F(4, 6, lo=0, hi=1)], d, grad=False),
        O("bipartite_match_per_prediction", lambda m, x: ops(
            m).bipartite_match(x, "per_prediction", 0.3),
          [_F(3, 7, lo=0, hi=1)], d, grad=False),
        O("target_assign", lambda m, x, i: ops(m).target_assign(
            x, i, mismatch_value=-2.0), [_F(5, 3), _I(-1, 5, 2, 4)], d),
        O("smooth_l1", lambda m, a, b, w1, w2: ops(m).smooth_l1(
            a, b, w1, w2, sigma=2.0), [_F(4, 3, 2), _F(4, 3, 2),
                                       _F(4, 3, 2, lo=0, hi=1),
                                       _F(4, 3, 2, lo=0, hi=1)], d),
        O("smooth_l1_plain", lambda m, a, b: ops(m).smooth_l1(a, b),
          [_F(5, 4), _F(5, 4)], d),
        O("polygon_box_transform", lambda m, x: ops(m).polygon_box_transform(
            x), [_F(1, 8, 3, 4)], d),
    ]


DET_CASES = _det_cases()


#: Faster R-CNN R50-FPN's test settings (PaddleDetection release/2.0,
#: configs/faster_rcnn/_base_/faster_rcnn_r50_fpn.yml)
FRCNN = dict(anchor_sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
             strides=(4, 8, 16, 32, 64), aspect_ratios=(0.5, 1.0, 2.0),
             variances=(1.0, 1.0, 1.0, 1.0), pre_nms_top_n=1000,
             post_nms_top_n=1000, nms_thresh=0.7, min_size=0.0,
             roi_levels=(2, 5), refer_level=4, refer_scale=224,
             resolution=7, sampling_ratio=0, aligned=True,
             box_variances=(0.1, 0.1, 0.2, 0.2), score_threshold=0.05,
             nms_threshold=0.5, keep_top_k=100)


def frcnn_inputs(n=2, size=(64, 80), width=4, seed=5):
    """Seeded stand-ins for the chain's inputs: FPN levels P2-P6 of an
    image of ``size``, RPN scores (distinct, spread over [-4, 4], so no
    two near-tie: ROADMAP C4) and deltas, and ``im_shape``."""
    rng = np.random.default_rng(seed)
    h, w = size
    feats, scores, deltas = [], [], []
    for s in FRCNN["strides"]:
        fh, fw = -(-h // s), -(-w // s)
        feats.append(rng.standard_normal((n, width, fh, fw)
                                         ).astype(np.float32))
        k = n * 3 * fh * fw
        scores.append((rng.permutation(k).reshape(n, 3, fh, fw) / k * 8 - 4
                       ).astype(np.float32))
        deltas.append(rng.uniform(-0.3, 0.3, (n, 12, fh, fw)
                                  ).astype(np.float32))
    im = np.tile(np.array([[h, w]], np.float32), (n, 1))
    return feats, scores, deltas, im


def rpn_to_rois(m, feats, rpn_scores, rpn_deltas, im_shape, cfg=FRCNN):
    """The RPN's proposals over the FPN levels P2-P6, as a PaddleDetection
    user writes them from package ``m``'s ops: per level
    ``anchor_generator`` and ``generate_proposals`` (all images in one
    call), then per image ``collect_fpn_proposals`` over the levels.
    ``feats``, ``rpn_scores`` ``[N, 3, H, W]`` and ``rpn_deltas``
    ``[N, 12, H, W]`` are lists by level. Returns rois ``[N * post, 4]``
    (the images' in turn) and ``rois_num`` (a NumPy array)."""
    ops = m.ops
    rois, scores = [], []
    for lv, f in enumerate(feats):
        anc, var = ops.anchor_generator(
            f, anchor_sizes=[cfg["anchor_sizes"][lv]],
            aspect_ratios=list(cfg["aspect_ratios"]),
            variances=list(cfg["variances"]),
            stride=[float(cfg["strides"][lv])] * 2)
        r, s, _ = ops.generate_proposals(
            rpn_scores[lv], rpn_deltas[lv], im_shape, anc, var,
            pre_nms_top_n=cfg["pre_nms_top_n"],
            post_nms_top_n=cfg["post_nms_top_n"],
            nms_thresh=cfg["nms_thresh"], min_size=cfg["min_size"])
        rois.append(r)
        scores.append(s)
    n = rpn_scores[0].shape[0]
    post = cfg["post_nms_top_n"]
    per_image = [ops.collect_fpn_proposals([r[i] for r in rois],
                                           [s[i] for s in scores], post)[0]
                 for i in range(n)]
    return m.concat(per_image, axis=0), np.full(n, post, np.int64)


def roi_features(m, feats, rois, rois_num, cfg=FRCNN):
    """``distribute_fpn_proposals`` over P2-P5, then ``roi_align`` of each
    level on its rois, merged by the levels' masks: ``[R, C, 7, 7]``."""
    ops = m.ops
    lo, hi = cfg["roi_levels"]
    level_rois, masks, _ = ops.distribute_fpn_proposals(
        rois, lo, hi, cfg["refer_level"], cfg["refer_scale"])
    out = None
    for k, (r, mask) in enumerate(zip(level_rois, masks)):
        pooled = ops.roi_align(
            feats[k], r, cfg["resolution"],
            spatial_scale=1.0 / cfg["strides"][k],
            sampling_ratio=cfg["sampling_ratio"], rois_num=rois_num,
            aligned=cfg["aligned"])
        keep = m.cast(m.reshape(mask, [-1, 1, 1, 1]), pooled.dtype)
        out = pooled * keep if out is None else out + pooled * keep
    return out


def detect(m, rois, cls_logits, box_deltas, box_var, n, cfg=FRCNN):
    """The head's outputs to detections: ``box_coder`` decodes each roi's
    deltas ``[R, 4]`` (``box_var`` ``[4]``), softmax scores over ``C+1``
    classes, then ``multiclass_nms`` per image (background 0, every roi a
    candidate). Returns ``(out [n, keep_top_k, 6], counts [n])``."""
    boxes = m.ops.box_coder(rois, box_var, box_deltas,
                            code_type="decode_center_size",
                            box_normalized=False)
    r = rois.shape[0] // n
    c = cls_logits.shape[-1]
    scores = m.transpose(m.reshape(m.nn.functional.softmax(cls_logits, -1),
                                   [n, r, c]), [0, 2, 1])
    return m.ops.multiclass_nms(
        m.reshape(boxes, [n, r, 4]), scores,
        score_threshold=cfg["score_threshold"], nms_top_k=r,
        keep_top_k=cfg["keep_top_k"], nms_threshold=cfg["nms_threshold"],
        normalized=False, background_label=0)


def test_a9_case_names_are_unique():
    names = [c.name for c in RNN_CASES + DET_CASES]
    assert len(names) == len(set(names))
