"""Tensor-parallel layers over the ``mp`` mesh axis (counterpart of
``paddle_tpu/distributed/fleet/mp_layers.py``; reference
``meta_parallel/parallel_layers/mp_layers.py``: ``VocabParallelEmbedding``
:29, ``ColumnParallelLinear`` :96, ``RowParallelLinear`` :169).

As in the JAX package, each layer owns the *global* weight, laid out over
``mp`` (a DTensor parameter, ``distributed/mesh.py``), and pins its
activations' layout; DTensor's propagation then gives the reference's
compute and collectives: the column layer's input is replicated
(identity forward, all-reduce backward), the row layer's partial product
is all-reduced, and the vocab-parallel table is looked up where it lies
and the partial lookups summed (``mesh.embedding``). ``gather_output``
and ``input_is_parallel`` keep their meanings, as the layout of the
returned or accepted activation. Without an ``mp`` axis of more than one
rank the layers are plain layers.
"""
from __future__ import annotations

from ...core.generator import get_rng_state_tracker  # noqa: F401
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layer_base import Layer
from .. import mesh as _mesh

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "model_parallel_random_seed", "get_rng_state_tracker", "split"]


def _mp_size() -> int:
    return _mesh.mesh_axis_size("mp")


def _pin(x, *spec_axes):
    """``x`` laid out as ``spec_axes`` (the identity without an ``mp``
    axis)."""
    if _mp_size() <= 1:
        return x
    return _mesh.constrain(x, spec_axes)


def _shard_param(layer, name, spec_axes):
    if _mp_size() > 1:
        _mesh.shard_tensor(getattr(layer, name), spec_axes)


class VocabParallelEmbedding(Layer):
    """reference: mp_layers.py:29: the table sharded on the vocab dim."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self, "weight", ("mp", None))

    def forward(self, x):
        out = F.embedding(x, self.weight)
        return _pin(out, *((None,) * out.dim()))


class ColumnParallelLinear(Layer):
    """reference: mp_layers.py:96: the weight split on its output dim."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        if out_features % max(_mp_size(), 1) != 0:
            raise ValueError(
                f"out_features {out_features} not divisible by mp degree "
                f"{_mp_size()}")
        self.gather_output = gather_output
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self, "weight", (None, "mp"))
        self.bias = self.create_parameter(
            [out_features], attr=None, is_bias=True) if has_bias else None
        if self.bias is not None:
            _shard_param(self, "bias", ("mp",))

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            return _pin(y, *((None,) * y.dim()))
        return _pin(y, *((None,) * (y.dim() - 1) + ("mp",)))


class RowParallelLinear(Layer):
    """reference: mp_layers.py:169: the weight split on its input dim;
    the bias is added after the reduction, replicated."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        if in_features % max(_mp_size(), 1) != 0:
            raise ValueError(
                f"in_features {in_features} not divisible by mp degree "
                f"{_mp_size()}")
        self.input_is_parallel = input_is_parallel
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        _shard_param(self, "weight", ("mp", None))
        self.bias = self.create_parameter(
            [out_features], attr=None, is_bias=True) if has_bias else None
        if self.bias is not None and _mp_size() > 1:
            _mesh.replicate_tensor(self.bias)

    def forward(self, x):
        if self.input_is_parallel:
            x = _pin(x, *((None,) * (x.dim() - 1) + ("mp",)))
        y = F.linear(x, self.weight, None)
        y = _pin(y, *((None,) * y.dim()))       # the all-reduce
        if self.bias is not None:
            y = y + self.bias
        return y


class ParallelCrossEntropy(Layer):
    """reference: mp_layers.py ParallelCrossEntropy: softmax cross entropy
    over logits sharded on the class dim (the plain loss on global
    semantics; DTensor gathers the class dim for the softmax)."""

    def __init__(self, mp_group=None, name=None):
        super().__init__()

    def forward(self, logits, labels):
        logits = _pin(logits, *((None,) * (logits.dim() - 1) + ("mp",)))
        return F.cross_entropy(logits, labels)


def model_parallel_random_seed(seed):
    """reference: parallel_layers/random.py model_parallel_random_seed."""
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("model_parallel_rng", int(seed))


def split(x, size, operation, axis=0, num_partitions=None, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference: ``python/paddle/distributed/collective.py:1154``
    ``split``: build the partitioned layer and apply it (a builder, called
    once at model construction, as in the reference).
    ``operation="linear"``: ``size=(in, out)``, ``axis=1`` column-parallel,
    ``axis=0`` row-parallel; ``"embedding"``: ``size=(vocab, hidden)``,
    the table vocab-partitioned."""
    if num_partitions is not None and num_partitions != max(_mp_size(), 1):
        raise ValueError(
            f"num_partitions={num_partitions} does not match the mesh's "
            f"mp degree {_mp_size()}")
    if bias_attr not in (None, False, True):
        raise NotImplementedError(
            "split() supports bias_attr None/True/False; build the "
            "Column/RowParallelLinear directly for a custom bias attr")
    if operation == "linear":
        in_f, out_f = size
        if axis == 1:
            layer = ColumnParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                has_bias=bias_attr is not False, gather_output=gather_out)
        elif axis == 0:
            layer = RowParallelLinear(
                in_f, out_f, weight_attr=weight_attr,
                has_bias=bias_attr is not False)
        else:
            raise ValueError("linear split axis must be 0 or 1")
        return layer(x)
    if operation == "embedding":
        if bias_attr not in (None, False):
            raise ValueError("embedding split takes no bias")
        vocab, hidden = size
        layer = VocabParallelEmbedding(vocab, hidden,
                                       weight_attr=weight_attr)
        return layer(x)
    raise ValueError(f"unknown split operation {operation!r}")
