"""``paddle.nn.utils`` (counterpart of ``paddle_tpu/nn/utils``):
``weight_norm``, ``remove_weight_norm``, ``spectral_norm`` (the hook
form, ``spectral_norm_fn``), ``parameters_to_vector`` and
``vector_to_parameters``."""
from ...ops import manipulation
from ..utils_weight_norm import remove_weight_norm, weight_norm
from ..utils_weight_norm import spectral_norm_fn as spectral_norm

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def parameters_to_vector(parameters, name=None):
    """One flat vector of every parameter, in order (op ``concat``)."""
    return manipulation.concat([manipulation.flatten(p) for p in
                                parameters], axis=0)


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive pieces of ``vec`` into the parameters, in
    place."""
    offset = 0
    for p in parameters:
        n = p.numel()
        p.set_value(manipulation.reshape(vec[offset:offset + n],
                                         list(p.shape)))
        offset += n
