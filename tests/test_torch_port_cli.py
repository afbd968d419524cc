"""The experiment YAML and the train CLI's ``--config`` against the JAX
package.

The port's YAML reader (``cv_diffusion_tpu_torch/yaml_subset.py``) is held
to ``yaml.safe_load`` (PyYAML, YAML 1.1 resolution) exactly: on
``configs/default.yaml``, on one case for each of the resolution rules
that differ from YAML 1.2, and on its own writer's output; what lies
outside the subset must raise with its line number. ``load_yaml`` and
``to_dict`` are held to the JAX package's field for field, and
``train.resolve_config`` to ``scripts/train.py``'s (loaded from its path)
for several command lines, with and without ``--config``.
"""

import dataclasses
import importlib.util
import math
import os

import pytest
import yaml

from cv_diffusion_tpu import config as jconfig
from cv_diffusion_tpu_torch import config as tconfig
from cv_diffusion_tpu_torch import train as tcli
from cv_diffusion_tpu_torch.yaml_subset import YAMLSubsetError, dumps, loads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_YAML = os.path.join(REPO, "configs", "default.yaml")


def same(a, b) -> bool:
    """Equal values of equal types, NaN equal to NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) and type(k) is type(k2)
                                          for k, k2 in zip(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def test_default_yaml_reads_as_pyyaml_reads_it():
    with open(DEFAULT_YAML) as f:
        text = f.read()
    assert same(loads(text), yaml.safe_load(text))


# one case for each YAML 1.1 rule PyYAML resolves by, and the layouts the
# configs use
@pytest.mark.parametrize("text", [
    "lr: 1.0e-4",            # a float: a dot and a signed exponent
    "lr: 1e-4",              # no dot: the string '1e-4'
    "lr: 1.0e4",             # an unsigned exponent: a string
    "lr: .5", "lr: 1.", "lr: -.inf", "lr: .NaN", "lr: 1_000.5",
    "flag: on", "flag: Off", "flag: YES", "flag: no", "flag: yEs", "flag: True",
    "v: ~", "v: null", "v: NULL", "v:", "v: Nul",
    "n: 012", "n: 08", "n: 0x1F", "n: 0b101", "n: 1_000", "n: 1:30", "n: -0", "n: +12",
    "t: 190:20:30.15",
    "s: 'it''s'", 's: "a\\tb\\u00e9"', "s: ''", "s: b#c", "s: b # a comment",
    "s: data/our485", "s: low-light-diffusion-tpu",
    "l: [1, 2.5, x, 'y', null, on]", "l: []", "m: {}",
    "l:\n- 4\n- 8", "l:\n  - 4\n  - 8",
    "a:\n  b:\n    c: 1\n  d: [16, 8]\ne: 2",
    "---\na: 1", "yes: 1", "1: one", "a: 1\na: 2",
])
def test_resolution_quirks_read_as_pyyaml_reads_them(text):
    assert same(loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2", 2), ("a: *alias", 1), ("a: !!str 1", 1),
    ("a: |\n  block", 1), ("a: >\n  folded", 1), ("a: 1\n---\nb: 2", 2),
    ("a: 1\n...\n", 2), ("%YAML 1.1\n---\na: 1", 1), ("a: 2001-12-14", 1),
    ("<<: {}", 1), ("a:\n- b: 1", 2), ("a:\n- [1]", 2), ("a: plain\n  continued", 2),
    ("a: {b: 1}", 1), ("? a\n: b", 1), ("a: [1, [2]]", 1), ("a:\n\tb: 1", 2),
    ("a: 'open", 1), ("a:\n  b: 1\n c: 2", 3),
])
def test_outside_the_subset_is_refused_with_its_line(text, line):
    with pytest.raises(YAMLSubsetError, match=f"^line {line}: ") as err:
        loads(text)
    assert err.value.line == line


def test_writer_round_trips_through_both_readers():
    tree = {"a": {"b": [1, 2], "c": 1e-6, "d": "1e-4", "e": "yes", "f": None,
                  "g": True, "h": "x: y", "i": "it's", "j": "tab\there", "k": [],
                  "l": {}, "m": float("inf"), "n": "08", "o": 1e20, "p": "\u2028x",
                  "q": -0.0, "r": "", "s": "~", "t": 1.5e-07, "u": "#c", "v": "-x"},
            "w": (2.0, 5.0)}
    text = dumps(tree)
    want = dict(tree, w=[2.0, 5.0])
    assert same(loads(text), want) and same(yaml.safe_load(text), want)


def test_save_yaml_writes_what_pyyaml_writes(tmp_path):
    """The port's ``save_yaml`` of the default experiment is byte for byte
    the JAX package's (``yaml.safe_dump``), and both packages read either
    file back to the same config."""
    tconfig.save_yaml(tconfig.ExperimentConfig(), tmp_path / "port.yaml")
    jconfig.save_yaml(jconfig.ExperimentConfig(), tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    changed = dataclasses.replace(tconfig.ExperimentConfig(), train=tconfig.TrainConfig(
        learning_rate=3e-5, mesh_shape=(1,), resume_from="ck/last.pt", epochs=7))
    tconfig.save_yaml(changed, tmp_path / "changed.yaml")
    assert tconfig.load_yaml(tmp_path / "changed.yaml") == changed
    assert tconfig.to_dict(changed) == jconfig.to_dict(
        jconfig.load_yaml(tmp_path / "changed.yaml"))


def test_load_yaml_equals_jax_field_for_field():
    port = tconfig.to_dict(tconfig.load_yaml(DEFAULT_YAML))
    jax_ = jconfig.to_dict(jconfig.load_yaml(DEFAULT_YAML))
    assert same(port, jax_)
    # every dataclass of the experiment has the JAX package's fields
    for name in ("ExperimentConfig", "DataConfig", "TrainConfig", "DiffusionConfig",
                 "UNetConfig", "SchedulerConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(tconfig, name))]
                == [f.name for f in dataclasses.fields(getattr(jconfig, name))]), name


@pytest.fixture(scope="module")
def jax_train_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_script", os.path.join(REPO, "scripts", "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def small_yaml(tmp_path_factory):
    """default.yaml with other data roots, no validation and a few train
    fields changed, written by the JAX package."""
    exp = jconfig.load_yaml(DEFAULT_YAML)
    exp = dataclasses.replace(
        exp, data=dataclasses.replace(exp.data, train_root="d/train", val_root=None,
                                      use_synthetic=True),
        train=dataclasses.replace(exp.train, epochs=3, use_amp=False, remat=True,
                                  learning_rate=2.5e-5))
    path = tmp_path_factory.mktemp("cfg") / "small.yaml"
    jconfig.save_yaml(exp, str(path))
    return str(path)


@pytest.mark.parametrize("argv", [
    [], ["--epochs", "3", "--no_amp", "--val_dir", "none"],
    ["--qat_act", "--lr", "3e-4", "--sync_checkpoints"],
    ["--config", "DEFAULT"], ["--config", "DEFAULT", "--epochs", "2", "--no_ema"],
    ["--config", "DEFAULT", "--data_dir", "x", "--val_dir", "", "--use_synthetic"],
    ["--config", "SMALL"], ["--config", "SMALL", "--lr=1e-3", "--variant", "tiny"],
    ["--config", "SMALL", "--val_dir", "v", "--no_warmup", "--batch_size", "8"],
])
def test_resolve_config_equals_jax(argv, jax_train_script, small_yaml):
    argv = [{"DEFAULT": DEFAULT_YAML, "SMALL": small_yaml}.get(a, a) for a in argv]
    want = jax_train_script.resolve_config(
        jax_train_script.build_parser().parse_args(argv), argv)
    got = tcli.resolve_config(tcli.build_parser().parse_args(argv), argv)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert got[1:] == want[1:]


def test_config_fields_the_port_refuses_raise_where_they_did(tmp_path):
    """A YAML's ``mesh_shape`` over several devices and ``use_wandb`` are
    read; ``use_wandb`` is refused by the trainer's check as the flag's
    value is, and ``mesh_shape`` passes it and lays out the processes of
    the group: (4,) does not cover this one process, with JAX
    ``make_mesh``'s error."""
    from cv_diffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cv_diffusion_tpu_torch.training.train_state import check_trainable
    from cv_diffusion_tpu_torch.training.trainer import resolve_mesh

    for field, value, match in (("mesh_shape", (4,), None),
                                ("use_wandb", True, "W&B")):
        exp = dataclasses.replace(tconfig.ExperimentConfig(), train=dataclasses.replace(
            tconfig.TrainConfig(), **{field: value}))
        tconfig.save_yaml(exp, tmp_path / f"{field}.yaml")
        config = tcli.resolve_config(
            tcli.build_parser().parse_args(["--config", str(tmp_path / f"{field}.yaml")]),
            ["--config", str(tmp_path / f"{field}.yaml")])[0]
        assert getattr(config, field) == value
        if match is None:
            check_trainable(config)
            with pytest.raises(ValueError) as want:
                jax_make_mesh(value, devices=jax_make_mesh().devices.ravel()[:1])
            with pytest.raises(ValueError) as got:
                resolve_mesh(None, config)
            assert str(got.value) == str(want.value)
            continue
        with pytest.raises(NotImplementedError, match=match):
            check_trainable(config)
