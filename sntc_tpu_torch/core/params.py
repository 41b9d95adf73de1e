"""Typed Param system — the user-facing configuration surface of every stage.

Behavioral spec: Spark ML's Params system (SURVEY.md §5.6; upstream
``mllib/src/main/scala/org/apache/spark/ml/param/params.scala`` [U]): every
pipeline stage declares typed ``Param``s with defaults + validators, settable
per-instance, readable via generated ``get<Name>()`` accessors, documented via
``explainParams()``, and serialized with the model
(sntc_tpu_torch.mlio.save_load).

A copy of the JAX package's ``core/params.py``: the port imports nothing
from that package, so its stages keep the same param surface here.

Differences from Spark (deliberate, single-process design):
  * no JVM mirror — params live only on the Python stage object;
  * ``set<Name>()``/``setParams()`` return ``self`` for chaining, as in PySpark.
"""

from __future__ import annotations

import copy as _copy
import uuid
from typing import Any, Callable, Dict, Optional


class _NoDefault:
    """Sentinel for params with no default (must be set before use)."""

    _instance: Optional["_NoDefault"] = None

    def __new__(cls) -> "_NoDefault":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover
        return "<undefined>"


NO_DEFAULT = _NoDefault()


class Param:
    """Descriptor declaring one typed parameter on a :class:`Params` subclass.

    Accessing the attribute on an *instance or class* returns the ``Param``
    object itself (PySpark convention: ``lr.maxIter`` is the Param; the value
    is read with ``lr.getMaxIter()`` / ``lr.getOrDefault("maxIter")``).
    """

    __slots__ = ("name", "doc", "default", "validator")

    def __init__(
        self,
        doc: str,
        default: Any = NO_DEFAULT,
        validator: Optional[Callable[[Any], bool]] = None,
        name: Optional[str] = None,
    ):
        self.name = name
        self.doc = doc
        self.default = default
        self.validator = validator

    def __set_name__(self, owner: type, name: str) -> None:
        if self.name is None:
            self.name = name

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> "Param":
        return self

    def validate(self, value: Any) -> Any:
        if self.validator is not None and not self.validator(value):
            raise ValueError(
                f"Param {self.name}={value!r} failed validation: {self.doc}"
            )
        return value

    def __repr__(self) -> str:
        return f"Param(name={self.name!r})"


class validators:
    """Common Param validators (the ``ParamValidators`` analog [U])."""

    @staticmethod
    def gt(lower: float) -> Callable[[Any], bool]:
        return lambda v: v > lower

    @staticmethod
    def gteq(lower: float) -> Callable[[Any], bool]:
        return lambda v: v >= lower

    @staticmethod
    def in_range(lo: float, hi: float) -> Callable[[Any], bool]:
        return lambda v: lo <= v <= hi

    @staticmethod
    def one_of(*allowed: Any) -> Callable[[Any], bool]:
        return lambda v: v in allowed

    @staticmethod
    def is_bool() -> Callable[[Any], bool]:
        return lambda v: isinstance(v, bool)

    @staticmethod
    def list_of(elem_ok: Callable[[Any], bool]) -> Callable[[Any], bool]:
        return lambda v: isinstance(v, (list, tuple)) and all(elem_ok(e) for e in v)


def _capitalize(name: str) -> str:
    return name[0].upper() + name[1:]


class Params:
    """Base class giving subclasses Spark-style param handling.

    Subclasses declare class-level :class:`Param` attributes; ``get<Name>`` /
    ``set<Name>`` accessors are generated automatically. Constructor keyword
    arguments set params by name.
    """

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        # Walk the full MRO so Param declarations on plain mixin classes
        # (shared estimator/model param blocks) get accessors too.
        declared: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for name, p in vars(klass).items():
                if isinstance(p, Param):
                    declared[name] = p
        for name, p in declared.items():
            cap = _capitalize(name)
            getter_name, setter_name = f"get{cap}", f"set{cap}"
            # generate only when no accessor exists anywhere in the MRO —
            # hand-written overrides (and inherited generated ones, which
            # resolve by name) must not be shadowed
            if not hasattr(cls, getter_name):
                def _getter(self: "Params", _n: str = name) -> Any:
                    return self.getOrDefault(_n)
                _getter.__name__ = getter_name
                _getter.__doc__ = f"Value of param ``{name}``: {p.doc}"
                _getter._sntc_generated = True
                setattr(cls, getter_name, _getter)
            if not hasattr(cls, setter_name):
                def _setter(self: "Params", value: Any, _n: str = name) -> "Params":
                    return self.set(_n, value)
                _setter.__name__ = setter_name
                _setter.__doc__ = f"Set param ``{name}``: {p.doc}"
                _setter._sntc_generated = True
                setattr(cls, setter_name, _setter)

    def __init__(self, **kwargs: Any):
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._paramMap: Dict[str, Any] = {}
        if kwargs:
            self.setParams(**kwargs)

    # -- declaration introspection -------------------------------------------

    @classmethod
    def params(cls) -> Dict[str, Param]:
        """All declared params, walking the MRO (subclass overrides win).

        Cached per class (the declaration set is fixed at class creation);
        callers must treat the returned dict as read-only.
        """
        cached = cls.__dict__.get("_sntc_params")
        if cached is None:
            cached = {}
            for klass in reversed(cls.__mro__):
                for name, p in vars(klass).items():
                    if isinstance(p, Param):
                        cached[name] = p
            cls._sntc_params = cached
        return cached

    def _param(self, param: Any) -> Param:
        if isinstance(param, Param):
            name = param.name
        else:
            name = param
        p = type(self).params().get(name)
        if p is None:
            raise AttributeError(f"{type(self).__name__} has no param {name!r}")
        return p

    # -- get / set ------------------------------------------------------------

    def set(self, param: Any, value: Any) -> "Params":
        p = self._param(param)
        self._paramMap[p.name] = p.validate(value)
        return self

    def setParams(self, **kwargs: Any) -> "Params":
        for name, value in kwargs.items():
            self.set(name, value)
        return self

    def getOrDefault(self, param: Any) -> Any:
        p = self._param(param)
        if p.name in self._paramMap:
            return self._paramMap[p.name]
        if p.default is NO_DEFAULT:
            raise KeyError(
                f"Param {p.name!r} of {type(self).__name__} has no default and "
                "was not set"
            )
        return p.default

    def isSet(self, param: Any) -> bool:
        return self._param(param).name in self._paramMap

    def isDefined(self, param: Any) -> bool:
        p = self._param(param)
        return p.name in self._paramMap or p.default is not NO_DEFAULT

    def hasParam(self, name: str) -> bool:
        return name in type(self).params()

    # -- documentation / serialization ----------------------------------------

    def explainParam(self, param: Any) -> str:
        p = self._param(param)
        default = "undefined" if p.default is NO_DEFAULT else repr(p.default)
        current = (
            repr(self._paramMap[p.name]) if p.name in self._paramMap else "default"
        )
        return f"{p.name}: {p.doc} (default: {default}, current: {current})"

    def explainParams(self) -> str:
        return "\n".join(
            self.explainParam(name) for name in sorted(type(self).params())
        )

    def paramValues(self, include_defaults: bool = True) -> Dict[str, Any]:
        """``{name: value}`` for every defined param — the save/load payload."""
        out: Dict[str, Any] = {}
        for name, p in type(self).params().items():
            if name in self._paramMap:
                out[name] = self._paramMap[name]
            elif include_defaults and p.default is not NO_DEFAULT:
                out[name] = p.default
        return out

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        """Shallow-copy this stage, optionally overriding params (Spark
        ``copy(extra)`` semantics used by CrossValidator grid fits)."""
        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        if extra:
            for k, v in extra.items():
                new.set(k, v)
        return new

    def __repr__(self) -> str:
        parts = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items()))
        return f"{type(self).__name__}({parts})"
