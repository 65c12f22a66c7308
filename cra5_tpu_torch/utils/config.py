"""Python-file configuration system.

The port's own copy of ``cra5_tpu/utils/config.py`` (that module imports
no JAX, but the port imports nothing of the JAX package), with the same
semantics: ``Config.fromfile``, ``_base_`` inheritance, ``{{fileDirname}}``
and ``{{$VAR:default}}`` substitution and the lazy-import mode. It is a
small, dependency-free loader:
a config is an ordinary Python module executed in an isolated namespace;
``_base_`` lists parent config files merged recursively (child wins);
``{{fileDirname}}`` and ``{{$VAR:default}}`` placeholders are substituted
in string values.

Lazy-import mode (``fromfile(..., lazy_import=True)``, auto-detected from a
``with read_base():`` block): ``import``/``from ... import`` statements in
the config are parsed from the AST into :class:`LazyObject` placeholders
instead of being executed, so heavy dependencies named in ``type`` fields
are never imported at config-load time; ``with read_base():`` blocks hold
``from <module-ish path> import *`` statements that inherit other config
files by path. ``LazyObject.build()`` performs the real import.
"""

from __future__ import annotations

import ast
import copy
import importlib
import os
import re
import types
from typing import Any, Dict, Iterator, List, Mapping, Optional, Set, Tuple


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return ConfigDict({k: ConfigDict._wrap(v) for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _merge(base: Dict[str, Any], child: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge; child values win. ``_delete_=True`` in a child
    dict replaces the base dict instead of merging into it."""
    out = dict(base)
    for k, v in child.items():
        if (
            isinstance(v, Mapping)
            and isinstance(out.get(k), Mapping)
            and not v.get("_delete_", False)
        ):
            out[k] = _merge(dict(out[k]), v)
        else:
            if isinstance(v, Mapping):
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            out[k] = v
    return out


_ENV_RE = re.compile(r"\{\{\s*\$(\w+)\s*:\s*([^}]*)\}\}")
_PREDEF_RE = re.compile(r"\{\{\s*(fileDirname|fileBasename|fileBasenameNoExtension|fileExtname)\s*\}\}")


def _substitute(text: str, filename: str) -> str:
    dirname = os.path.dirname(os.path.abspath(filename))
    base = os.path.basename(filename)
    stem, ext = os.path.splitext(base)
    predefined = {
        "fileDirname": dirname,
        "fileBasename": base,
        "fileBasenameNoExtension": stem,
        "fileExtname": ext,
    }
    text = _PREDEF_RE.sub(lambda m: predefined[m.group(1)], text)
    text = _ENV_RE.sub(lambda m: os.environ.get(m.group(1), m.group(2)), text)
    return text


class LazyObject:
    """Placeholder for a module or attribute named in a lazy-import config:
    records the dotted path without importing anything (parity surface:
    reference utils/lazy.py LazyObject/LazyAttr via utils/config.py:986).
    Attribute access chains lazily; ``build()`` performs the import.

    ``ensure`` carries the full dotted module of an un-aliased
    ``import a.b.c`` (which binds the name ``a``): build() imports it
    first so the submodule attributes exist on the parent package."""

    def __init__(self, module: str, attr: str = "", ensure: str = ""):
        object.__setattr__(self, "module", module)
        object.__setattr__(self, "attr", attr)
        object.__setattr__(self, "ensure", ensure)

    def __getattr__(self, name: str) -> "LazyObject":
        if name.startswith("__"):
            raise AttributeError(name)
        attr = f"{self.attr}.{name}" if self.attr else name
        return LazyObject(self.module, attr, self.ensure)

    def build(self) -> Any:
        if self.ensure:
            importlib.import_module(self.ensure)
        obj: Any = importlib.import_module(self.module)
        if self.attr:
            for part in self.attr.split("."):
                obj = getattr(obj, part)
        return obj

    @property
    def dotted(self) -> str:
        return f"{self.module}.{self.attr}" if self.attr else self.module

    def __repr__(self) -> str:
        return f"LazyObject({self.dotted!r})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, LazyObject) and other.dotted == self.dotted

    def __hash__(self) -> int:
        return hash(self.dotted)

    def __deepcopy__(self, memo) -> "LazyObject":
        return LazyObject(self.module, self.attr, self.ensure)


def read_base():
    """Marker context manager for lazy-import configs. The parser handles
    ``with read_base():`` blocks specially; executing one outside a config
    file is a no-op."""
    import contextlib

    return contextlib.nullcontext()


def _is_read_base_with(node: ast.stmt) -> bool:
    if not isinstance(node, ast.With) or len(node.items) != 1:
        return False
    expr = node.items[0].context_expr
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id == "read_base"
    )


def _module_path_to_file(module: str, level: int, base_dir: str) -> str:
    """Resolve a read_base import target to a config file path: dots in
    ``level`` walk up from the config's directory, the module parts walk
    down, the last part is the ``.py`` file."""
    d = base_dir
    for _ in range(max(level - 1, 0)):
        d = os.path.dirname(d)
    parts = module.split(".") if module else []
    return os.path.join(d, *parts) + ".py"


def _parse_lazy_config(filename: str) -> Tuple[Dict[str, Any], Set[str]]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r") as f:
        source = _substitute(f.read(), filename)
    tree = ast.parse(source, filename)
    base_dir = os.path.dirname(filename)

    ns: Dict[str, Any] = {"__file__": filename}
    imported: Set[str] = set()
    body: List[ast.stmt] = []

    for node in tree.body:
        if _is_read_base_with(node):
            for stmt in node.body:
                if not isinstance(stmt, ast.ImportFrom) or not stmt.module:
                    raise SyntaxError(
                        "only 'from <config-file> import *' or named values "
                        "are allowed inside read_base() "
                        f"({filename}:{stmt.lineno})"
                    )
                base_file = _module_path_to_file(
                    stmt.module, stmt.level, base_dir
                )
                base_vars, base_imported = _parse_lazy_config(base_file)
                names = [a.name for a in stmt.names]
                if names == ["*"]:
                    ns.update(base_vars)
                    imported |= base_imported
                else:
                    for alias in stmt.names:
                        if alias.name not in base_vars:
                            raise ImportError(
                                f"{alias.name!r} not defined in {base_file}"
                            )
                        bound = alias.asname or alias.name
                        ns[bound] = base_vars[alias.name]
                        if alias.name in base_imported:
                            imported.add(bound)
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    ns[alias.asname] = LazyObject(alias.name)
                    imported.add(alias.asname)
                else:
                    # `import a.b.c` binds `a`; build() must import the
                    # full dotted module so `a.b` exists on the parent
                    top = alias.name.split(".")[0]
                    ns[top] = LazyObject(top, ensure=alias.name)
                    imported.add(top)
            continue
        if isinstance(node, ast.ImportFrom):
            if node.level > 0:
                raise SyntaxError(
                    "relative imports in a lazy config belong inside a "
                    f"'with read_base():' block ({filename}:{node.lineno})"
                )
            for alias in node.names:
                if alias.name == "*":
                    raise SyntaxError(
                        "'from <module> import *' is not supported in lazy "
                        "configs outside read_base() "
                        f"({filename}:{node.lineno})"
                    )
                ns[alias.asname or alias.name] = LazyObject(
                    node.module or "", alias.name
                )
                imported.add(alias.asname or alias.name)
            continue
        body.append(node)

    code = compile(
        ast.fix_missing_locations(ast.Module(body=body, type_ignores=[])),
        filename,
        "exec",
    )
    exec(code, ns)
    cfg = {
        k: v
        for k, v in ns.items()
        if not k.startswith("__")
        and not isinstance(v, (types.ModuleType, types.FunctionType, type))
    }
    return cfg, imported


def _exec_config_file(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, "r") as f:
        source = _substitute(f.read(), filename)
    module = types.ModuleType("_cra5_tpu_torch_config")
    module.__file__ = filename
    code = compile(source, filename, "exec")
    exec(code, module.__dict__)
    cfg = {
        k: v
        for k, v in vars(module).items()
        if not k.startswith("__") and not isinstance(v, (types.ModuleType, types.FunctionType, type))
    }
    return cfg


class Config:
    """A frozen-ish attribute-dict view over a merged config namespace."""

    def __init__(
        self,
        cfg_dict: Dict[str, Any] | None = None,
        filename: str | None = None,
        imported_names: Optional[Set[str]] = None,
    ):
        object.__setattr__(self, "_cfg", ConfigDict._wrap(cfg_dict or {}))
        object.__setattr__(self, "filename", filename)
        object.__setattr__(self, "_imported_names", set(imported_names or ()))

    @classmethod
    def fromfile(cls, filename: str, lazy_import: Optional[bool] = None) -> "Config":
        """Load a Python config file. ``lazy_import=None`` auto-detects the
        lazy syntax (a ``with read_base():`` block); True forces it."""
        if lazy_import is None:
            with open(os.path.abspath(os.path.expanduser(filename))) as f:
                source = f.read()
            # cheap substring pre-filter, then confirm an actual
            # `with read_base():` block in the AST (a comment or string
            # mentioning read_base must not flip an eager config to lazy)
            lazy_import = "read_base" in source and any(
                _is_read_base_with(n)
                for n in ast.parse(source, filename).body
            )
        if lazy_import:
            cfg, imported = _parse_lazy_config(filename)
            return cls(cfg, filename=filename, imported_names=imported)
        cfg = _exec_config_file(filename)
        bases = cfg.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            if not os.path.isabs(b):
                b = os.path.join(os.path.dirname(os.path.abspath(filename)), b)
            merged = _merge(merged, cls.fromfile(b).to_dict())
        merged = _merge(merged, cfg)
        return cls(merged, filename=filename)

    @classmethod
    def fromdict(cls, d: Mapping[str, Any]) -> "Config":
        return cls(dict(d))

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(dict(self._cfg))

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg.get(key, default)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name: str) -> Any:
        return self._cfg[name]

    def __setitem__(self, name: str, value: Any) -> None:
        self._cfg[name] = ConfigDict._wrap(value)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg[name] = ConfigDict._wrap(value)

    def __contains__(self, name: str) -> bool:
        return name in self._cfg

    def __iter__(self) -> Iterator[str]:
        return iter(self._cfg)

    def keys(self) -> List[str]:
        return list(self._cfg.keys())

    def items(self):
        return self._cfg.items()

    def __repr__(self) -> str:
        return f"Config(filename={self.filename!r}, keys={list(self._cfg)})"

    @property
    def pretty_text(self) -> str:
        import pprint

        # names imported in a lazy config are accessible but, like the
        # reference, excluded from dumps (they are code, not config values)
        shown = {
            k: v for k, v in self._cfg.items() if k not in self._imported_names
        }
        return pprint.pformat(shown, width=100, sort_dicts=False)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.pretty_text)
