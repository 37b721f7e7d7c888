"""The hybrid-parallel topology (counterpart of
``paddle_tpu/distributed/topology.py``; reference
``fleet/base/topology.py:35`` ``CommunicateTopology``, ``:111``
``HybridCommunicateGroup``).

Each parallel dimension is an axis of the global mesh
(``distributed/mesh.py``), and its communication group is the mesh's
subgroup along that axis for this rank: the same ranks as the JAX
package's axis groups for the same degrees (rank-major over data, pipe,
sharding, sep, model), and the reference's one ring per axis slice.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

import numpy as np

from . import mesh as _mesh
from .collective import new_group


class CommunicateTopology:
    """reference: fleet/base/topology.py:35."""

    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe", "model"),
                 dims: Sequence[int] = (1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self.coordinate = list(itertools.product(*[range(d) for d in self._dims]))
        self._rank2coord = {r: c for r, c in enumerate(self.coordinate)}
        self._coord2rank = {c: r for r, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return int(np.prod(self._dims))

    def get_rank(self, **kwargs) -> int:
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self._coord2rank[coord]

    def get_coord(self, rank: int):
        return self._rank2coord[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` equals ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._rank2coord.items() if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Rank lists of every group that communicates along ``axis_name``
        (reference: topology.py get_comm_list)."""
        axis = self._parallel_names.index(axis_name)
        others = [self._parallel_names[i] for i in range(len(self._dims))
                  if i != axis]
        comm = []
        for combo in itertools.product(
                *[range(self.get_dim(o)) for o in others]):
            ranks = []
            for k in range(self.get_dim(axis_name)):
                kw = dict(zip(others, combo))
                kw[axis_name] = k
                ranks.append(self.get_rank(**kw))
            comm.append(ranks)
        return comm


# paddle axis name -> mesh axis name
_AXIS_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "sep": "sp", "model": "mp"}


class HybridCommunicateGroup:
    """reference: fleet/base/topology.py:111. Built from the hybrid dims; also
    installs the matching global Mesh so collectives and sharding agree."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
                 sharding_degree: int = 1, sep_degree: int = 1,
                 rank: Optional[int] = None, devices=None):
        if topology is not None:
            dims = {n: topology.get_dim(n)
                    for n in topology.get_hybrid_group_names()}
            dp_degree = dims.get("data", 1)
            pp_degree = dims.get("pipe", 1)
            mp_degree = dims.get("model", 1)
            sharding_degree = dims.get("sharding", 1)
            sep_degree = dims.get("sep", 1)
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree
        self._sep_degree = sep_degree

        names, dims = [], []
        for n, d in (("data", dp_degree), ("pipe", pp_degree),
                     ("sharding", sharding_degree), ("sep", sep_degree),
                     ("model", mp_degree)):
            names.append(n)
            dims.append(d)
        self._topo = CommunicateTopology(names, dims)

        from .env import get_rank
        self.global_rank = rank if rank is not None else get_rank()
        self.nranks = self._topo.world_size()

        # install the global mesh (only axes with degree > 1, in hybrid
        # order; a world of one gets a 1-rank dp mesh)
        axes = {}
        for n, d in zip(names, dims):
            if d > 1:
                axes[_AXIS_MAP[n]] = d
        from .env import get_world_size, is_initialized
        ranks = list(devices) if devices is not None else \
            list(range(get_world_size()))
        need = int(np.prod(list(axes.values()) or [1]))
        existing = _mesh.get_mesh()
        if need == len(ranks) and is_initialized():
            _mesh.set_mesh(_mesh.build_mesh(axes or None, ranks))
        elif existing is not None and all(
                _mesh.mesh_axis_size(a, existing) == d
                for a, d in axes.items()):
            pass  # a mesh the caller installed already has these axes
        elif need > 1:
            # a mesh skipped without a word would make every dp/mp/pp
            # collective the identity: refuse instead
            raise ValueError(
                f"hybrid degrees {axes} need {need} ranks but the world "
                f"has {len(ranks)}; fix hybrid_configs, start that many "
                f"ranks, or install a matching mesh (distributed.set_mesh)")

        self._dp_group = new_group(axis="dp")
        self._mp_group = new_group(axis="mp")
        self._pp_group = new_group(axis="pp")
        self._sharding_group = new_group(axis="sharding")
        self._sep_group = new_group(axis="sp")
        # check group: dp×sharding (reference: topology.py _check_comm_group)
        self._check_group = new_group(axis=("dp", "sharding"))

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._mp_degree > 1:
            return "model"
        if self._sharding_degree > 1:
            return "sharding"
        return "data"

    def _coord(self):
        return self._topo.get_coord(self.global_rank)

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # data parallel
    def get_data_parallel_rank(self):
        return self._coord()[0]

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return self._topo.get_axis_list("data", 0)[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self):
        return self._coord()[4]

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return 0

    # pipeline parallel
    def get_stage_id(self):
        return self._coord()[1]

    def get_pipe_parallel_rank(self):
        return self._coord()[1]

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._pp_group

    @property
    def is_first_stage(self):
        return self.get_stage_id() == 0

    @property
    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    # sharding
    def get_sharding_parallel_rank(self):
        return self._coord()[2]

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return 0

    def get_check_parallel_group(self):
        return self._check_group

    def get_rank_from_stage(self, stage_id, **kwargs):
        c = list(self._coord())
        c[1] = stage_id
        return self._topo.get_rank(data=c[0], pipe=c[1], sharding=c[2],
                                   sep=c[3], model=c[4])


_HCG = [None]


def set_hybrid_communicate_group(hcg):
    _HCG[0] = hcg


def get_hybrid_communicate_group():
    return _HCG[0]
