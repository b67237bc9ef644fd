"""Legacy-spelling attribute compatibility.

Historic getdist scripts mix camelCase and snake_case attribute spellings;
settings/plotter objects accept both, warning on the legacy form, and honor
per-class ``_deprecated`` tables mapping old names to replacements (or to
``None`` for attributes that were removed outright). Behavioral contract
follows reference ``getdist/_base.py`` with an original implementation:
legacy names resolve lazily via ``__getattr__`` (ordinary access pays no
interception cost) and the camel->snake conversion is a character scan
rather than regex substitution.
"""

import logging

REMOVED = "removed"
ALIASED = "aliased"
UNKNOWN = "unknown"


def _to_snake(name):
    """camelCase/PascalCase -> snake_case (upper runs stay grouped: ABCWord -> abc_word)."""
    chars = []
    for i, ch in enumerate(name):
        if ch.isupper() and i:
            before = name[i - 1]
            after = name[i + 1] if i + 1 < len(name) else ""
            starts_word = before.islower() or before.isdigit() or (before.isupper() and after.islower())
            if starts_word and chars and chars[-1] != "_":
                chars.append("_")
        chars.append(ch.lower())
    return "".join(chars)


def _legacy_target(obj, name):
    """Classify a failed attribute name: (status, canonical_name)."""
    table = type(obj).__dict__.get("_deprecated") or {}
    if name in table:
        target = table[name]
        return (REMOVED, None) if target is None else (ALIASED, target)
    snake = _to_snake(name)
    if snake != name:
        return ALIASED, snake
    return UNKNOWN, None


class _BaseObject:
    """Accepts pep8 and camelCase attribute spellings interchangeably."""

    _fail_on_not_exist = False

    def __getattr__(self, name):
        # only reached when normal lookup failed -> legacy spelling or typo
        if name.startswith("__"):
            raise AttributeError(name)
        status, target = _legacy_target(self, name)
        if status == REMOVED:
            logging.warning("%s is removed and will be ignored", name)
            return None
        if status == ALIASED:
            sentinel = object()
            value = getattr(self, target, sentinel)
            if value is not sentinel:
                logging.warning("%s is deprecated, use %s", name, target)
                return value
        raise AttributeError("%s is not a valid attribute for class %s" % (name, type(self)))

    def __setattr__(self, name, value):
        if name in self.__dict__ or hasattr(type(self), name):
            return object.__setattr__(self, name, value)
        status, target = _legacy_target(self, name)
        if status == REMOVED:
            logging.warning("%s is removed and will be ignored", name)
            return
        if status == ALIASED and hasattr(self, target):
            return object.__setattr__(self, target, value)
        if object.__getattribute__(self, "_fail_on_not_exist"):
            raise AttributeError("Unknown attribute %s for class %s" % (name, type(self)))
        object.__setattr__(self, name, value)
