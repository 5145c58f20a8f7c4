"""Property tree (pnode) (``ginkgo_tpu/config/property_tree.py``, verbatim).

Analog of ``include/ginkgo/core/config/property_tree.hpp:28-37``: a tagged
union of map / array / scalar.  In Python the natural carrier is plain
dict/list/scalars (what ``json.load`` yields); ``pnode`` wraps them with the
reference's typed accessors for API parity and validation errors.
"""

from __future__ import annotations


class pnode:
    """Wraps a JSON-like value: dict (map), list (array), or scalar."""

    def __init__(self, value=None):
        self.value = value

    # -- tag queries ----------------------------------------------------------
    @property
    def is_map(self):
        return isinstance(self.value, dict)

    @property
    def is_array(self):
        return isinstance(self.value, list)

    @property
    def is_scalar(self):
        return not (self.is_map or self.is_array or self.value is None)

    @property
    def is_empty(self):
        return self.value is None

    # -- accessors -------------------------------------------------------------
    def get(self, key: str) -> "pnode":
        if not self.is_map:
            raise TypeError(f"pnode.get({key!r}) on non-map node")
        return pnode(self.value.get(key))

    def at(self, idx: int) -> "pnode":
        if not self.is_array:
            raise TypeError(f"pnode.at({idx}) on non-array node")
        return pnode(self.value[idx])

    def get_string(self) -> str:
        if not isinstance(self.value, str):
            raise TypeError(f"expected string, got {self.value!r}")
        return self.value

    def get_integer(self) -> int:
        if isinstance(self.value, bool) or not isinstance(self.value, int):
            raise TypeError(f"expected integer, got {self.value!r}")
        return self.value

    def get_real(self) -> float:
        if isinstance(self.value, bool) or not isinstance(
                self.value, (int, float)):
            raise TypeError(f"expected real, got {self.value!r}")
        return float(self.value)

    def get_boolean(self) -> bool:
        if not isinstance(self.value, bool):
            raise TypeError(f"expected boolean, got {self.value!r}")
        return self.value

    def items(self):
        if not self.is_map:
            raise TypeError("items() on non-map node")
        return self.value.items()

    def __len__(self):
        if self.is_map or self.is_array:
            return len(self.value)
        return 0 if self.is_empty else 1

    def __repr__(self):
        return f"pnode({self.value!r})"
