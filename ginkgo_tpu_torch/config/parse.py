"""Runtime config → factory parsing (``ginkgo_tpu/config/parse.py`` in
torch).

Analog of ``include/ginkgo/core/config/config.hpp:197`` (``config::parse``)
with the per-component parse functions (``core/config/*_config.cpp``), the
named-object ``registry`` (``registry.hpp:167``), ``type_descriptor``
(``type_descriptor.hpp:39``), and the JSON front end
(``include/ginkgo/extensions/config/json_config.hpp`` /
``examples/file-config-solver``).

Config grammar mirrors Ginkgo's: a map with ``"type": "solver::Cg"`` plus
parameters; nested maps are sub-configs; strings resolve through the
registry when a component slot expects an object; ``"criteria"`` arrays
fold into a Combined criterion.
"""

from __future__ import annotations

import json

from ..base.dtypes import as_torch_dtype
from ..base.exceptions import NotSupportedError
from .property_tree import pnode


class registry:
    """Name → user object store (``registry.hpp:167``)."""

    def __init__(self, objects=None):
        self._objects = dict(objects or {})

    def emplace(self, name, obj):
        self._objects[name] = obj

    def search_data(self, name):
        if name not in self._objects:
            raise KeyError(f"registry has no object named {name!r}")
        return self._objects[name]

    def __contains__(self, name):
        return name in self._objects


class type_descriptor:
    """Default value/index types applied to parsed components
    (``type_descriptor.hpp:39``), as torch dtypes; names such as
    ``"float64"`` are accepted."""

    def __init__(self, value_type="float64", index_type="int32"):
        self.value_type = as_torch_dtype(value_type)
        self.index_type = as_torch_dtype(index_type)


def _type_table():
    from ..solver import (Bicg, Bicgstab, CbGmres, Cg, Cgs, Chebyshev, Fcg,
                          Gcr, Gmres, Idr, Ir, LowerTrs, Minres, Multigrid,
                          PipeCg, UpperTrs)
    from ..solver.direct import Direct
    from ..preconditioner.jacobi import Jacobi
    from ..preconditioner.ilu import Ic, Ilu
    from ..preconditioner.isai import Isai
    from ..preconditioner.sor import GaussSeidel, Sor
    from ..factorization.par_ilu import Ic0, Ilu0, ParIc, ParIlu
    from ..factorization.par_ilut import ParIct, ParIlut
    from ..factorization.direct import Cholesky, Lu
    from ..multigrid.pgm import FixedCoarsening, Pgm
    from ..distributed.schwarz import Schwarz
    from ..reorder import Amd, Mc64, NestedDissection, Rcm, ScaledReordered
    from ..stop.criterion import (ImplicitResidualNorm, Iteration,
                                  ResidualNorm, Time)

    def direct_ctor(cls):
        return lambda **kw: cls(**kw)

    table = {
        # solvers (SolverAPI exposes .build)
        "solver::Cg": Cg.build, "solver::Bicg": Bicg.build,
        "solver::Bicgstab": Bicgstab.build, "solver::Cgs": Cgs.build,
        "solver::Fcg": Fcg.build, "solver::Gmres": Gmres.build,
        "solver::CbGmres": CbGmres.build, "solver::Gcr": Gcr.build,
        "solver::Idr": Idr.build, "solver::Minres": Minres.build,
        "solver::Ir": Ir.build, "solver::Chebyshev": Chebyshev.build,
        "solver::PipeCg": PipeCg.build,
        "solver::Multigrid": Multigrid.build,
        "solver::Direct": Direct.build,
        "solver::LowerTrs": LowerTrs.build,
        "solver::UpperTrs": UpperTrs.build,
        # preconditioners
        "preconditioner::Jacobi": direct_ctor(Jacobi),
        "preconditioner::Ilu": direct_ctor(Ilu),
        "preconditioner::Ic": direct_ctor(Ic),
        "preconditioner::Isai": direct_ctor(Isai),
        "preconditioner::Sor": direct_ctor(Sor),
        "preconditioner::GaussSeidel": direct_ctor(GaussSeidel),
        "preconditioner::Schwarz": direct_ctor(Schwarz),
        # factorizations
        "factorization::ParIlu": direct_ctor(ParIlu),
        "factorization::ParIc": direct_ctor(ParIc),
        "factorization::ParIlut": direct_ctor(ParIlut),
        "factorization::ParIct": direct_ctor(ParIct),
        "factorization::Ilu": direct_ctor(Ilu0),
        "factorization::Ic": direct_ctor(Ic0),
        "factorization::Lu": direct_ctor(Lu),
        "factorization::Cholesky": direct_ctor(Cholesky),
        # multigrid levels
        "multigrid::Pgm": direct_ctor(Pgm),
        "multigrid::FixedCoarsening": direct_ctor(FixedCoarsening),
        # reorderings
        "reorder::Rcm": direct_ctor(Rcm), "reorder::Amd": direct_ctor(Amd),
        "reorder::Mc64": direct_ctor(Mc64),
        "reorder::NestedDissection": direct_ctor(NestedDissection),
        "reorder::ScaledReordered": direct_ctor(ScaledReordered),
        # stopping criteria
        "stop::Iteration": direct_ctor(Iteration),
        "stop::ResidualNorm": direct_ctor(ResidualNorm),
        "stop::ImplicitResidualNorm": direct_ctor(ImplicitResidualNorm),
        "stop::Time": direct_ctor(Time),
    }
    return table


def parse(config, context: registry = None, td: type_descriptor = None):
    """Parse a config map (dict or pnode) into a factory/criterion."""
    if isinstance(config, pnode):
        config = config.value
    if not isinstance(config, dict):
        raise TypeError(f"config must be a map, got {type(config)}")
    if "type" not in config:
        raise ValueError("config map needs a 'type' entry")
    table = _type_table()
    tname = config["type"]
    if tname not in table:
        raise NotSupportedError(f"unknown config type {tname!r}; known: "
                                f"{sorted(table)[:8]}...")
    builder = table[tname]
    kwargs = {}
    for key, val in config.items():
        if key == "type":
            continue
        kwargs[key] = _parse_value(val, context, td)
    if "criteria" in kwargs and isinstance(kwargs["criteria"], list):
        from ..stop.criterion import Combined
        kwargs["criteria"] = Combined(criteria=tuple(kwargs["criteria"]))
    return builder(**kwargs)


def _parse_value(val, context, td):
    if isinstance(val, dict) and "type" in val:
        return parse(val, context, td)
    if isinstance(val, list):
        return [_parse_value(v, context, td) for v in val]
    if isinstance(val, str) and context is not None and val in context:
        return context.search_data(val)
    return val


def parse_json(path_or_str, context: registry = None,
               td: type_descriptor = None):
    """JSON front end (``json_config.hpp`` analog): accepts a file path or a
    JSON string."""
    s = str(path_or_str)
    if s.lstrip().startswith("{"):
        cfg = json.loads(s)
    else:
        with open(s) as f:
            cfg = json.load(f)
    return parse(cfg, context, td)


def parse_yaml(path_or_str, context: registry = None,
               td: type_descriptor = None):
    """YAML front end (``yaml_config.hpp`` analog): accepts a file path or a
    YAML string.  Anchors/aliases and the ``<<`` merge key resolve exactly
    as the reference's yaml-cpp front end does
    (``include/ginkgo/extensions/config/yaml_config.hpp:44-70`` resolves
    ``<<`` manually; PyYAML's SafeLoader implements the same merge-key
    semantics natively).  Needs PyYAML, imported here on first use."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("parse_yaml requires pyyaml") from e
    s = str(path_or_str)
    looks_inline = "\n" in s or ":" in s.split("/")[-1]
    if looks_inline and not s.endswith((".yaml", ".yml")):
        cfg = yaml.safe_load(s)
    else:
        with open(s) as f:
            cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError("YAML config root must be a mapping")
    return parse(cfg, context, td)
