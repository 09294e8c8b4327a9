"""The port's hypes generator against the JAX package's: both write the
same 73 files byte for byte (the JAX generator's output root patched to a
temporary directory), equal to the port's copies; and the YAML writer's
``sort_keys=False`` and anchors / aliases equal to PyYAML's
``safe_dump`` on shared lists and dicts."""
import os
import subprocess
import sys

import pytest
import yaml

from hmvit_tpu.config import generate_hypes as jgen
from hmvit_tpu_torch.config import generate_hypes
from hmvit_tpu_torch.data.codecs import yaml_dump, yaml_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """(port names, port root, JAX root): each generator run once into a
    directory of its own."""
    port = str(tmp_path_factory.mktemp("port_hypes"))
    theirs = str(tmp_path_factory.mktemp("jax_hypes"))
    names = generate_hypes.generate(port)
    patch = pytest.MonkeyPatch()
    patch.setattr(jgen, "HERE", theirs)
    try:
        for gen in (jgen.gen_opv2v, jgen.gen_opcamera, jgen.gen_opcl,
                    jgen.gen_v2xt, jgen.gen_exact_twins):
            gen()
    finally:
        patch.undo()
    return names, port, theirs


def read(root, name):
    with open(os.path.join(root, name), "rb") as f:
        return f.read()


def test_generators_write_the_same_73_names(written):
    names, _, theirs = written
    jax_names = sorted(os.path.relpath(os.path.join(d, n), theirs)
                       for d, _, fs in os.walk(theirs) for n in fs)
    assert len(names) == 73 and names == jax_names


def test_generated_files_byte_equal_to_jax_and_to_the_copies(written):
    names, port, theirs = written
    copies = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
    for name in names:
        mine = read(port, name)
        assert mine == read(theirs, name), name
        assert mine == read(copies, name), name
    # every file shares a range or a voxel size between its blocks
    assert all(b"&id001" in read(port, name) for name in names)


def test_cli_writes_to_out(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "hmvit_tpu_torch.config.generate_hypes",
         "--out", str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "(73 files)" in out.stdout
    assert os.path.isfile(tmp_path / "opv2v" / "visualization.yaml")


def shared_cases():
    a = [1, 2.5]
    d = {"x": 1, "y": [3]}
    empty, empty_map = [], {}
    x = [0.1, "s"]
    nest = {"z": x, "w": [x]}
    return {
        "shared_list": {"b": a, "a": a, "c": [a, a]},
        "shared_dict": {"d": d, "n": {"q": d}, "c": [d, {"k": d}]},
        "shared_empty": {"e": empty, "f": empty, "g": empty_map,
                         "h": empty_map, "t": [empty, empty]},
        "nested_share": {"z": nest, "a": nest, "m": [[[x]]],
                         "q": [x, [x]], "s": [[a, [5]], a], "b": a},
        "second_meeting_numbers": {"u": {"l": a, "v": d},
                                   "w": {"v": d, "l": a}},
    }


@pytest.mark.parametrize("case", sorted(shared_cases()))
@pytest.mark.parametrize("sort_keys", [True, False])
def test_yaml_dump_equals_pyyaml(case, sort_keys):
    """Byte-equal to ``yaml.safe_dump``, and read back equal, the aliases
    the anchored object itself."""
    value = shared_cases()[case]
    text = yaml_dump(value, sort_keys=sort_keys)
    assert text == yaml.safe_dump(value, sort_keys=sort_keys)
    back = yaml_load(text, hypes=True)
    assert back == value
    if case == "shared_list":
        assert back["a"] is back["b"]


def test_yaml_dump_default_sorts_and_unshared_has_no_anchor():
    value = {"b": [1], "a": {"d": [1], "c": 2}}
    assert yaml_dump(value) == yaml.safe_dump(value)
    assert "&" not in yaml_dump(value)
    assert yaml_dump(value, sort_keys=False).startswith("b:")
