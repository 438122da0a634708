"""Configuration system: the port's copy of ``liftreg_tpu/utils/config.py``
(plain Python; the port imports nothing of the JAX package).

defaults and self-documenting comments.

API-compatible re-implementation of the reference's ``ParameterDict``
(``src/liftreg/utils/module_parameters.py``): reading
``opt[('key', default, 'docstring')]`` materializes missing keys, records
the used value in a parallel ``int`` tree and the docstring in a ``com``
tree; ``load_JSON``/``write_ext_JSON``/``write_JSON``/``write_JSON_comments``
round-trip ``cur_task_setting.json`` files unchanged.
"""
from __future__ import annotations

import json


class TrackedConfig:
    """Read-tracking view over a nested config mapping.

    Every ``[key]`` / ``.get(key)`` read records the key's dotted path in a
    set shared across the whole tree; ``unconsumed()`` then lists every leaf
    key that was never read. This gives the config system "teeth" the
    reference lacks: ``ParameterDict`` records what WAS read
    (``module_parameters.py`` ``int`` tree) but nothing ever checks for keys
    that were silently ignored (e.g. ``check_best_model_frequency``,
    ``cur_task_setting.json:28``). The trainer wraps its setting in this and
    warns about accepted-but-unused keys at the end of construction.

    Quacks like both a plain dict (``get``/``in``/iteration) and a
    ``ParameterDict`` (``as_dict()``, tuple reads ``cfg[("key", default)]``),
    so it can flow through every existing consumer unchanged.
    """

    def __init__(self, data, consumed=None, prefix=""):
        if hasattr(data, "as_dict"):
            data = data.as_dict()
        self._data = data
        self._consumed = consumed if consumed is not None else set()
        self._prefix = prefix

    def _path(self, key):
        return f"{self._prefix}.{key}" if self._prefix else str(key)

    def __contains__(self, key):
        return key in self._data

    def __getitem__(self, key):
        if isinstance(key, tuple):  # ParameterDict (key, default[, doc]) read
            k = key[0]
            default = key[1] if len(key) > 1 else None
            return self[k] if k in self._data else default
        value = self._data[key]
        self._consumed.add(self._path(key))
        if isinstance(value, dict):
            return TrackedConfig(value, self._consumed, self._path(key))
        return value

    def __setitem__(self, key, value):
        self._data[key] = value
        self._consumed.add(self._path(key))

    def get(self, key, default=None):
        return self[key] if key in self._data else default

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self[k]) for k in self._data)

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def as_dict(self):
        """Keeps tracking live for consumers that unwrap via ``as_dict()``."""
        return self

    def raw(self):
        return self._data

    def consumed(self):
        return set(self._consumed)

    def unconsumed(self):
        """Dotted paths of every leaf key that was never read."""
        out = []

        def walk(node, prefix):
            for k, v in node.items():
                p = f"{prefix}.{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(v, p)
                elif p not in self._consumed:
                    out.append(p)

        walk(self._data, self._prefix)
        return out


class ParameterDict:
    def __init__(self, init=None, printSettings=True):
        if init is not None and isinstance(init, ParameterDict):
            self.ext = init.ext
        elif isinstance(init, dict):
            self.ext = init
        else:
            self.ext = {}
        self.int = {}
        self.com = {}
        self.currentCategoryName = "root"
        self.printSettings = printSettings

    # -- IO -----------------------------------------------------------------
    def load_JSON(self, file_name):
        try:
            with open(file_name) as f:
                if self.printSettings:
                    print("Loading parameter file = " + str(file_name))
                self.ext = json.load(f)
        except IOError:
            print(f"Could not open file = {file_name}; ignoring request.")

    def write_JSON(self, file_name, save_int=True):
        with open(file_name, "w") as f:
            json.dump(self.int if save_int else self.ext, f, indent=4,
                      sort_keys=True)

    def write_ext_JSON(self, file_name):
        with open(file_name, "w") as f:
            json.dump(self.ext, f, indent=4, sort_keys=True)

    def write_JSON_comments(self, file_name):
        with open(file_name, "w") as f:
            json.dump(self.com, f, indent=4, sort_keys=True)

    def write_JSON_and_JSON_comments(self, file_names):
        self.write_JSON(file_names[0])
        self.write_JSON_comments(file_names[1])

    # -- plumbing -----------------------------------------------------------
    def print_settings_on(self):
        self.printSettings = True

    def print_settings_off(self):
        self.printSettings = False

    def get_print_settings(self):
        return self.printSettings

    def _child(self, key):
        child = ParameterDict(printSettings=self.printSettings)
        child.ext = self.ext[key]
        child.int = self.int.setdefault(key, {})
        child.com = self.com.setdefault(key, {})
        child.currentCategoryName = self.currentCategoryName + "." + str(key)
        return child

    def __contains__(self, key):
        return key in self.ext

    def __str__(self):
        return (f"ext = {self.ext}\nint = {self.int}\ncom = {self.com}\n"
                f"currentCategoryName = {self.currentCategoryName}\n")

    def as_dict(self):
        return self.ext

    # -- get ----------------------------------------------------------------
    def __getitem__(self, key_or_tuple):
        if isinstance(key_or_tuple, tuple):
            parts = key_or_tuple + (None, None)
            key, default, comment = parts[0], parts[1], parts[2]
            if len(key_or_tuple) > 3:
                raise ValueError("Tuple of incorrect size")
            return self._get(key, default, comment)
        return self._get(key_or_tuple)

    def _get(self, key, default=None, comment=None):
        if key in self.ext:
            value = self.ext[key]
            if isinstance(value, dict):
                if comment and "__doc__" not in self.com.setdefault(key, {}):
                    self.com[key]["__doc__"] = comment
                return self._child(key)
            self.int[key] = value
            if comment:
                self.com[key] = comment
            return value
        # materialize a default
        if default is None:
            default = {}
        if isinstance(default, dict):
            if default:
                raise ValueError("Cannot create a default key of type dict()")
            self.ext[key] = {}
            self.int[key] = {}
            self.com[key] = {"__doc__": comment} if comment else {}
            return self._child(key)
        self.ext[key] = default
        self.int[key] = default
        if comment:
            self.com[key] = comment
        if self.printSettings:
            print(f"Using default value = {default} for key = {key} of "
                  f"category = {self.currentCategoryName}")
        return default

    # -- set ----------------------------------------------------------------
    def __setitem__(self, key, value_tuple):
        comment = None
        if isinstance(value_tuple, tuple):
            if len(value_tuple) == 2:
                value, comment = value_tuple
            elif len(value_tuple) == 1:
                value, comment = {}, value_tuple[0]
            else:
                raise ValueError("Expected a 2-tuple as input")
        else:
            value = value_tuple

        if isinstance(value, ParameterDict):
            self.ext[key] = value.ext
            self.int[key] = {}
            self.com[key] = {}
            return
        if isinstance(value, dict):
            if value:
                raise ValueError("Can only add empty dictionaries")
            if key not in self.ext or not isinstance(self.ext[key], dict):
                self.ext[key] = {}
            self.int[key] = {}
            self.com[key] = {"__doc__": comment} if comment else {}
            return
        self.ext[key] = value
        self.int[key] = value
        if comment:
            self.com[key] = comment
