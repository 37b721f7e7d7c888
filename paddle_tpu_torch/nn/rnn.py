"""Recurrent layers (counterpart of ``paddle_tpu/nn/rnn.py``):
``RNNCellBase``, ``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``,
``SimpleRNN``, ``LSTM``, ``GRU`` and ``BiRNN``.

Gate orders, initialisers and parameter names are the reference's: an
LSTM's gates are ``i, f, g, o``, a GRU's ``r, z, n``; every weight and
bias is drawn from ``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))``; the
stacked layers name their cells ``cell_{layer}_{direction}`` with
``weight_ih`` ``[gates * hidden, input]``, ``weight_hh``, ``bias_ih`` and
``bias_hh``, so :func:`~paddle_tpu_torch.framework_io.state_dict_from_reference`
carries the JAX package's weights 1:1.

The time loop of one cell over a sequence is ONE funnel op,
``rnn_scan_{lstm,gru,rnn}``, as the JAX package's ``lax.scan`` is
(``_scan_rnn``): inside it a Python loop over ``T`` runs plain torch ops
(no funnel call a step), the input projection of all ``T`` steps is one
GEMM hoisted out of the loop, and within a step the arithmetic keeps
the reference's order (``(x W_ih^T + b_ih) + h W_hh^T + b_hh``). The loop
reads nothing on the host (``T`` and the masks are fixed by the input's
shape and the length tensor), so a train step that runs it can be
captured as a CUDA graph; its backward is torch autograd's. There is one
implementation on every device: cuDNN's RNN computes another masking
contract and another order, so it is no lane of the port.

``sequence_length`` follows the reference's contract: the forward
direction reads step ``t``, the reverse direction reads ``len-1-t`` (its
own valid prefix reversed), rows past their length keep their state and
emit zeros, and the reverse outputs go back to their source positions
(a gather by the inverse index, which gives the values the reference's
scatter-add does). A cell that is none of the three kinds runs the
simple-RNN body over its ``weight_ih``/``weight_hh``/``bias_ih``/
``bias_hh``, as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..core import dtypes as _dt
from ..core.device import DeviceLike, resolve_device
from ..core.tensor import Tensor
from ..ops import creation
from ..ops import manipulation as mp
from ..ops.dispatch import apply
from . import functional as F
from . import initializer as I
from .layer_base import Layer
from .layers_common import _param, _reset

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU", "BiRNN"]


class RNNCellBase(Layer):
    """The cells' base: :meth:`get_initial_states` gives the zero (or
    ``init_value``) state ``[batch, hidden]`` on the reference's device."""

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        raw = batch_ref._data if isinstance(batch_ref, Tensor) else batch_ref
        b = raw.shape[batch_dim_idx]
        out = apply("fill_constant", creation._fill,
                    shape=[b, self.hidden_size], value=init_value,
                    dtype=_dt.convert_dtype(dtype) or torch.float32,
                    device=raw.device)
        return Tensor._wrap(out) if isinstance(batch_ref, Tensor) else out

    def _make(self, gates, input_size, hidden_size, attrs, device, dtype):
        self.input_size, self.hidden_size = input_size, hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-k, k)
        dev = resolve_device(device)
        for name, shape, attr in (
                ("weight_ih", [gates * hidden_size, input_size], attrs[0]),
                ("weight_hh", [gates * hidden_size, hidden_size], attrs[1]),
                ("bias_ih", [gates * hidden_size], attrs[2]),
                ("bias_hh", [gates * hidden_size], attrs[3])):
            _param(self, name, shape, attr, dev, dtype, init)

    reset_parameters = _reset


def _promoted(*ts):
    """The tensors in their common floating type (the JAX package's
    promotion of mixed types inside the op)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _simple_step(act):
    fn = torch.tanh if act == "tanh" else torch.relu

    def step(xw_t, h, wh_t, bh):
        h2 = fn(xw_t + torch.mm(h, wh_t) + bh)
        return h2, h2
    return step


def _lstm_step(xw_t, carry, wh_t, bh):
    h, c = carry
    gates = xw_t + torch.mm(h, wh_t) + bh
    i, f, g, o = gates.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return (h2, c2), h2


def _gru_step(xw_t, h, wh_t, bh):
    hg = torch.mm(h, wh_t) + bh
    xr, xz, xn = xw_t.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h2 = (1 - z) * n + z * h
    return h2, h2


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self._make(1, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)
        step = _simple_step(self.activation)

        def impl(x, h, wi, wh, bi, bh):
            x, h, wi, wh, bi, bh = _promoted(x, h, wi, wh, bi, bh)
            return step(torch.mm(x, wi.t()) + bi, h, wh.t(), bh)
        return apply("simple_rnn_cell", impl, inputs, states, self.weight_ih,
                     self.weight_hh, self.bias_ih, self.bias_hh)


class LSTMCell(RNNCellBase):
    """reference: rnn.py:1038 (gate order i, f, g, o)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._make(4, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   dtype)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs, dtype=inputs.dtype)
            states = (h, h)

        def impl(x, h, c, wi, wh, bi, bh):
            x, h, c, wi, wh, bi, bh = _promoted(x, h, c, wi, wh, bi, bh)
            state, y = _lstm_step(torch.mm(x, wi.t()) + bi, (h, c), wh.t(),
                                  bh)
            return y, state
        return apply("lstm_cell", impl, inputs, states[0], states[1],
                     self.weight_ih, self.weight_hh, self.bias_ih,
                     self.bias_hh)


class GRUCell(RNNCellBase):
    """reference: rnn.py:1181 (paddle's GRU: ``n = tanh(x_n + r * h_n)``
    with ``h_n`` including its bias)."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__()
        self._make(3, input_size, hidden_size, (weight_ih_attr,
                   weight_hh_attr, bias_ih_attr, bias_hh_attr), device,
                   dtype)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, dtype=inputs.dtype)

        def impl(x, h, wi, wh, bi, bh):
            x, h, wi, wh, bi, bh = _promoted(x, h, wi, wh, bi, bh)
            return _gru_step(torch.mm(x, wi.t()) + bi, h, wh.t(), bh)
        return apply("gru_cell", impl, inputs, states, self.weight_ih,
                     self.weight_hh, self.bias_ih, self.bias_hh)


class RNN(Layer):
    """A cell run over a sequence (reference: rnn.py:238 RNN), as one
    ``rnn_scan_*`` op."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _scan_rnn(self.cell, inputs, initial_states, sequence_length,
                         self.is_reverse, self.time_major)


def _kind(cell):
    return ("lstm" if isinstance(cell, LSTMCell)
            else "gru" if isinstance(cell, GRUCell) else "rnn")


def _scan(kind, act, x, wi, wh, bi, bh, seq_len, init, is_reverse,
          time_major):
    """The op ``rnn_scan_{kind}`` on torch tensors: ``(ys, h)`` or
    ``(ys, h, c)`` for an LSTM."""
    tensors = [x, wi, wh, bi, bh] + list(init)
    x, wi, wh, bi, bh, *init = _promoted(*tensors)
    if not time_major:
        x = x.transpose(0, 1)                              # [T, B, I]
    t_n, b = x.shape[0], x.shape[1]
    alive = pos_c = None
    if seq_len is not None:
        sl = seq_len.to(torch.int64)
        t_idx = torch.arange(t_n, device=x.device)[:, None]
        if is_reverse:
            pos_c = (sl[None, :] - 1 - t_idx).clamp(0, t_n - 1)   # [T, B]
            x = torch.take_along_dim(x, pos_c[:, :, None], dim=0)
        alive = t_idx < sl[None, :]                        # [T, B]
    elif is_reverse:
        x = torch.flip(x, [0])
    hidden = wh.shape[1]
    if init:
        carry = (init[0], init[1]) if kind == "lstm" else init[0]
    else:
        z = x.new_zeros((b, hidden))
        carry = (z, z) if kind == "lstm" else z
    step = {"lstm": _lstm_step, "gru": _gru_step}.get(kind) or \
        _simple_step(act)
    # the input projection of every step in one GEMM
    xw = torch.matmul(x, wi.t()) + bi                      # [T, B, G]
    wh_t = wh.t()
    am = None if alive is None else alive[:, :, None].to(x.dtype)
    ys = []
    for t in range(t_n):
        new, y = step(xw[t], carry, wh_t, bh)
        if am is not None:
            a = am[t]
            if kind == "lstm":
                new = (new[0] * a + carry[0] * (1 - a),
                       new[1] * a + carry[1] * (1 - a))
            else:
                new = new * a + carry * (1 - a)
            y = y * a
        carry = new
        ys.append(y)
    ys = torch.stack(ys, 0)
    if alive is not None and is_reverse:
        # back to the source positions: position p of a row holds the
        # output of step len-1-p (the same index), zero past its length
        ys = torch.where(alive[:, :, None],
                         torch.take_along_dim(ys, pos_c[:, :, None], dim=0),
                         torch.zeros((), dtype=ys.dtype, device=ys.device))
    elif is_reverse:
        ys = torch.flip(ys, [0])
    if not time_major:
        ys = ys.transpose(0, 1)
    if kind == "lstm":
        return ys, carry[0], carry[1]
    return ys, carry


def _scan_rnn(cell, inputs, initial_states, sequence_length, is_reverse,
              time_major):
    kind = _kind(cell)
    act = getattr(cell, "activation", "tanh")
    with_len = sequence_length is not None

    def impl(x, wi, wh, bi, bh, *rest):
        seq_len = rest[0] if with_len else None
        init = rest[1:] if with_len else rest
        return _scan(kind, act, x, wi, wh, bi, bh, seq_len, init,
                     is_reverse, time_major)

    args = [inputs, cell.weight_ih, cell.weight_hh, cell.bias_ih,
            cell.bias_hh]
    if with_len:
        args.append(sequence_length)
    if initial_states is not None:
        if kind == "lstm":
            args += [initial_states[0], initial_states[1]]
        else:
            args.append(initial_states)
    out = apply(f"rnn_scan_{kind}", impl, *args)
    if kind == "lstm":
        ys, h, c = out
        return ys, (h, c)
    return out[0], out[1]


class _MultiLayerRNN(Layer):
    """Stacked, optionally bidirectional recurrent network (reference:
    rnn.py LSTM :1460, GRU :1616, SimpleRNN :1322): each layer's cells
    ``cell_{layer}_{direction}``, dropout between layers while training,
    final states stacked ``[layers * directions, batch, hidden]``."""

    MODE = "rnn"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        cell_cls = {"rnn": SimpleRNNCell, "lstm": LSTMCell,
                    "gru": GRUCell}[self.MODE]
        kw = {"activation": activation} if self.MODE == "rnn" else {}
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else \
                hidden_size * self.num_directions
            for d in range(self.num_directions):
                self.add_sublayer(f"cell_{layer}_{d}", cell_cls(
                    in_sz, hidden_size, weight_ih_attr=weight_ih_attr,
                    weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                    bias_hh_attr=bias_hh_attr, device=device, dtype=dtype,
                    **kw))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_out = []
        x = inputs
        idx = 0
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.num_directions):
                cell = getattr(self, f"cell_{layer}_{d}")
                init = None
                if initial_states is not None:
                    if self.MODE == "lstm":
                        init = (initial_states[0][idx],
                                initial_states[1][idx])
                    else:
                        init = initial_states[idx]
                ys, st = _scan_rnn(cell, x, init, sequence_length,
                                   is_reverse=(d == 1),
                                   time_major=self.time_major)
                outs.append(ys)
                states_out.append(st)
                idx += 1
            x = mp.concat(outs, axis=-1) if self.num_directions == 2 \
                else outs[0]
            if self.dropout and layer < self.num_layers - 1:
                x = F.dropout(x, self.dropout, training=self.training)
        if self.MODE == "lstm":
            h = mp.stack([s[0] for s in states_out], 0)
            c = mp.stack([s[1] for s in states_out], 0)
            return x, (h, c)
        return x, mp.stack(states_out, 0)


class SimpleRNN(_MultiLayerRNN):
    MODE = "rnn"


class LSTM(_MultiLayerRNN):
    MODE = "lstm"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)


class GRU(_MultiLayerRNN):
    MODE = "gru"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device: DeviceLike = None,
                 dtype=torch.float32):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype)


class BiRNN(Layer):
    """reference: nn/layer/rnn.py BiRNN: a forward and a backward cell
    over the same sequence, outputs concatenated on the feature axis."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        # the wrappers hold the registered cells; left unregistered so the
        # state dict names each cell once, as the reference's does
        self.__dict__["fw"] = RNN(cell_fw, is_reverse=False,
                                  time_major=time_major)
        self.__dict__["bw"] = RNN(cell_bw, is_reverse=True,
                                  time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, last_fw = self.fw(inputs, st_fw, sequence_length)
        out_bw, last_bw = self.bw(inputs, st_bw, sequence_length)
        return mp.concat([out_fw, out_bw], axis=2), (last_fw, last_bw)
