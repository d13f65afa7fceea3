"""The port's lineage keys equal the JAX package's, profile for profile.

A plugin's spec (``PluginSpec.to_dict()``, options with their help text
included) feeds ``spec_hash`` and so every lineage key below it: a cache
written by one package is found by the other only if each data name's key
is the same. Each pair registers a profile in a CPU Context of each
package (the JAX ``tpu`` profile against the port's ``cuda``); for every
data name, the spec dict and ``key_for`` must be equal.
"""

import pytest

from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.plugins import plugin_sets as jsets
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets

PAIRS = [("cpu", "cpu"), ("cpu_default", "cpu_default"), ("default", "default"),
         ("streaming", "streaming"), ("streaming_default", "streaming_default"),
         ("tpu", "cuda")]


@pytest.fixture(scope="module", params=PAIRS, ids=[f"{j}-{t}" for j, t in PAIRS])
def contexts(request, tmp_path_factory):
    jax_profile, port_profile = request.param
    root = tmp_path_factory.mktemp(port_profile)
    jctx = JContext(storage_dir=str(root / "jax"), config={"show_progress": False})
    jctx.register(*jsets.get_profile(jax_profile))
    tctx = TContext(storage_dir=str(root / "port"),
                    config={"show_progress": False, "device": "cpu"})
    tctx.register(*tsets.get_profile(port_profile))
    return jctx, tctx


def test_same_data_names(contexts):
    jctx, tctx = contexts
    assert sorted(tctx.plugins) == sorted(jctx.plugins) and len(jctx.plugins) > 20


def test_specs_equal(contexts):
    jctx, tctx = contexts
    for name, plugin in jctx.plugins.items():
        want = plugin._validated_spec
        got = tctx.plugins[name]._validated_spec
        assert got.to_dict() == want.to_dict(), name
        assert got.spec_hash() == want.spec_hash(), name


def test_keys_equal(contexts):
    jctx, tctx = contexts
    differ = [name for name in sorted(jctx.plugins)
              if tctx.key_for("r", name) != jctx.key_for("r", name)]
    assert differ == []
