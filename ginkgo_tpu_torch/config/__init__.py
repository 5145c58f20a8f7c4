"""Runtime config (core/config + extensions/config analogs)."""

from .property_tree import pnode  # noqa: F401
from .parse import (parse, parse_json, parse_yaml, registry,  # noqa: F401
                    type_descriptor)
