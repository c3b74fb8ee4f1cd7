"""The port's YAML reader (``ladcast_torch.utils.registry.load_yaml``), which
needs no PyYAML, against ``yaml.safe_load``: every shipped config, PyYAML's
YAML 1.1 types, and the refusal (file and line) of what it does not read;
the dotted-target factory against the JAX package's."""

import datetime
import glob
import os
import sys

import pytest
import yaml

from ladcast_torch.utils import registry as t_reg
from ladcast_tpu.utils import registry as j_reg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _types(x):
    if isinstance(x, dict):
        return {k: _types(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_types(v) for v in x]
    return type(x).__name__


def test_every_shipped_config_is_read():
    assert [os.path.basename(p) for p in CONFIGS] == [
        "dcae_84.yaml", "dcae_84_ft_decoder.yaml", "dcae_ray_1024.yaml",
        "ladcast_1p6b.yaml", "ladcast_375m.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_config_equals_safe_load(path, monkeypatch):
    """The same object, types included, with PyYAML blocked from import."""
    with open(path) as f:
        want = yaml.safe_load(f)
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = t_reg.load_yaml(path)
    assert got == want
    assert _types(got) == _types(want)


def test_shipped_quirks_stay_as_pyyaml_reads_them():
    lr = t_reg.load_yaml(os.path.join(ROOT, "configs", "ladcast_375m.yaml"))
    assert lr["optimizer"]["lr"] == "1e-4" and lr["optimizer"]["eps"] == "1e-08"
    dl = lr["train_dataloader"]
    assert dl["start_date"] == "1979-01-01T05"
    assert dl["end_date"] == datetime.date(2017, 12, 31) and dl["ds_path"] is None
    p16 = t_reg.load_yaml(os.path.join(ROOT, "configs", "ladcast_1p6b.yaml"))
    assert p16["parallel"]["mesh"] == {"data": -1, "model": 8}
    ray = t_reg.load_yaml(os.path.join(ROOT, "configs", "dcae_ray_1024.yaml"))
    assert ray["encdec"]["encoder_qkv_multiscales"] == [[], [], [5], [5]]


SCALARS = ["1e-5", "1.0e-5", "1.0e5", "1.", ".5", "-.5", "+1", "-1", "0", "017",
           "0x1F", "0b101", "1_000", "1.5e+3", ".inf", "-.Inf", ".NaN", "yes",
           "Off", "ON", "no", "true", "False", "~", "null", "Null", "", "2017-12-31",
           "1979-01-01T05", "'it''s'", '"tab\\there\\u00e9"', "'1e-5'", "plain text",
           "b#c", "http://x.y/z", "[1, [2, [3]], []]", "[a, b,]", "[1.0e-5, 1e-5, '3']",
           "{x: 1, y: [a, b], 'z': \"q\"}", "{}", "[]", "[ResBlock, pixel_shuffle]"]


@pytest.mark.parametrize("text", SCALARS)
def test_values_equal_safe_load(text, tmp_path):
    path = tmp_path / "v.yaml"
    path.write_text(f"a: {text}  # a comment\nb:\n  c: {text}\n'q k': 1\n")
    want = yaml.safe_load(path.read_text())
    got = t_reg.load_yaml(str(path))
    assert repr(got) == repr(want)  # nan != nan, so compare the reprs
    assert _types(got) == _types(want)


DUMPED = [{"encoder_qkv_multiscales": [[], [], [5], [5]], "betas": [0.9, 0.999]},
          {"a": [1, [2, [3, []]], {"b": [{"c": None}, {}]}], "s": ["1e-5", "yes", "", "a: b"]},
          [{"x": 1, "y": [1, 2]}, [[]], "z"]]


@pytest.mark.parametrize("obj", [*CONFIGS, *DUMPED],
                         ids=[os.path.basename(p) for p in CONFIGS] + ["dumped"] * 3)
def test_safe_dump_output_reads_back(obj, tmp_path):
    """What ``yaml.safe_dump`` writes (block sequences, ``- - x``, ``- key:
    value``) reads back to the object, as users' and tests' configs are
    written."""
    if isinstance(obj, str):
        with open(obj) as f:
            obj = yaml.safe_load(f)
    path = tmp_path / "dumped.yaml"
    path.write_text(yaml.safe_dump(obj))
    assert t_reg.load_yaml(str(path)) == obj == yaml.safe_load(path.read_text())


def test_keys_and_nesting_equal_safe_load(tmp_path):
    text = ("# head\n\nouter:\n  inner:\n    deep: 1\n\n  # a comment inside\n"
            "  next: [1]\n2: int key\ntrue: bool key\nnull: null key\n"
            "last:\n")
    path = tmp_path / "k.yaml"
    path.write_text(text)
    assert t_reg.load_yaml(str(path)) == yaml.safe_load(text)
    (tmp_path / "e.yaml").write_text("# only a comment\n")
    assert t_reg.load_yaml(str(tmp_path / "e.yaml")) is None


REFUSED = [("a: &anchor 1\n", 1, "anchors"), ("a: 1\nb: *anchor\n", 2, "aliases"),
           ("a: !!str 1\n", 1, "tags"), ("a: 1\nb: |\n  text\n", 2, "block scalars"),
           ("a: >\n  text\n", 1, "block scalars"), ("a: - 1\n", 1, "sequence entry"),
           ("a:\n- 1\nb\n", 3, "expected 'key: value'"), ("a:\n- 1\n  - 2\n", 3, "indentation"),
           ("a: 1\n---\nb: 2\n", 2, "document markers"),
           ("a: [1,\n  2]\n", 1, "several lines"), ("a: plain\n  more\n", 2,
                                                     "multi-line scalars"),
           ("a: 'open\n  close'\n", 1, "several lines"), ("a: b: c\n", 1, "mapping"),
           ("a: 1\na: 2\n", 2, "duplicate key"), ("a: [b: 1]\n", 1, "flow sequence"),
           ("a: 12:30\n", 1, "sexagesimal"), ("x:\n\ta: 1\n", 2, "tabs"),
           ("a: 2001-12-14 21:59:43\n", 1, "time of day")]


@pytest.mark.parametrize("text,line,what", REFUSED, ids=[r[2] for r in REFUSED])
def test_refuses_what_it_does_not_read(text, line, what, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(t_reg.YamlSubsetError, match=what) as e:
        t_reg.load_yaml(str(path))
    assert str(e.value).startswith(f"{path}:{line}: ")


def test_dotted_targets_match_jax():
    cfg = {"target": "collections.OrderedDict", "params": {"a": 1}}
    assert t_reg.instantiate_from_config(cfg) == j_reg.instantiate_from_config(cfg)
    assert t_reg.get_obj_from_str("os.path.join") is j_reg.get_obj_from_str("os.path.join")
    with pytest.raises(KeyError, match="target"):
        t_reg.instantiate_from_config({"params": {}})
