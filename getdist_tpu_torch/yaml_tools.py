"""YAML loading helpers tolerant of scientific notation and foreign tags.

Role of the reference's ``getdist/yaml_tools.py:20-77``: standard PyYAML
treats ``1e-5`` (no decimal point / sign) as a string and explodes on
serialized python object tags; these loaders fix both and raise
syntax errors with file/line context.
"""

import re

import yaml

__all__ = ["yaml_load", "yaml_load_file", "InputSyntaxError"]


class InputSyntaxError(Exception):
    """YAML input file syntax error with context."""


_SCI_FLOAT = re.compile(
    r"""^(?:
        [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
       |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
       |[-+]?\.(?:inf|Inf|INF)
       |\.(?:nan|NaN|NAN)
       )$""",
    re.X,
)


def _make_loader():
    class _Loader(yaml.SafeLoader):
        pass

    # Accept 1e-5 style floats (YAML 1.1 resolver misses exponent-only forms).
    _Loader.add_implicit_resolver(
        "tag:yaml.org,2002:float", _SCI_FLOAT, list("-+0123456789.")
    )

    # Ignore serialized python object tags rather than erroring.
    def _ignore_python_tag(loader, suffix, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node)
        return loader.construct_scalar(node)

    _Loader.add_multi_constructor("tag:yaml.org,2002:python/", _ignore_python_tag)
    _Loader.add_multi_constructor("!", _ignore_python_tag)
    return _Loader


def yaml_load(text_stream, file_name=None):
    """Parse YAML from a string, with sci-notation floats and lenient tags."""
    try:
        return yaml.load(text_stream, _make_loader())
    except (yaml.YAMLError, TypeError) as exception:
        mark = getattr(exception, "problem_mark", None)
        where = ""
        if mark is not None:
            where = f" at line {mark.line + 1}, column {mark.column + 1}"
            if file_name:
                where = f" in {file_name}{where}"
        raise InputSyntaxError(f"Error in YAML input{where}: {exception}") from exception


def yaml_load_file(file_name):
    """Parse a YAML file (UTF-8 with optional BOM)."""
    with open(file_name, encoding="utf-8-sig") as handle:
        return yaml_load(handle.read(), file_name=file_name)
