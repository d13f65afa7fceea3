"""Named plugin sets and registration profiles.

Behavioral analog of the reference plugin sets / profiles
(reference: waveform_analysis/core/plugins/plugin_sets/__init__.py and
profiles.py:20-66): named groups of builtin plugins composable into a
profile.

Port of ``waveformanalysis_tpu/plugins/plugin_sets.py``. The default
profile takes a device-neutral name, ``cuda_default`` (the JAX package's
``tpu_default``, the same plugins in the same order, the records set
``records``, ``wave_pool``, ``wave_pool_filtered`` among them); its device
is the Context's (``config["device"]``). ``wave_source="auto"`` never
picks records: a plugin reads the records pool only when its
``wave_source`` is ``"records"``. ``streaming_default`` adds
``signal_peaks_stream`` to it, as in the JAX package. The JAX package's
``jax`` / ``jax_accel`` profiles have no meaning here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def plugins_io() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.waveforms import RawFileNamesPlugin

    return [RawFileNamesPlugin()]


def plugins_waveform() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.filtering import FilteredWaveformsPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveforms import WaveformsPlugin

    return [WaveformsPlugin(), FilteredWaveformsPlugin()]


def plugins_records() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.records import (
        RecordsPlugin,
        WavePoolFilteredPlugin,
        WavePoolPlugin,
    )

    return [RecordsPlugin(), WavePoolPlugin(), WavePoolFilteredPlugin()]


def plugins_peaks() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import ThresholdHitPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.hit_merge import (
        HitMergeClustersPlugin,
        HitMergedComponentsPlugin,
        HitMergePlugin,
    )
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin

    return [
        HitFinderPlugin(),
        ThresholdHitPlugin(),
        HitMergePlugin(),
        HitMergeClustersPlugin(),
        HitMergedComponentsPlugin(),
    ]


def plugins_basic_features() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width_integral import (
        WaveformWidthIntegralPlugin,
    )

    return [BasicFeaturesPlugin(), WaveformWidthPlugin(), WaveformWidthIntegralPlugin()]


def plugins_classification() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import (
        S1S2ClassifierPlugin,
    )

    return [S1S2ClassifierPlugin()]


def plugins_tabular() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.dataframe import DataFramePlugin

    return [DataFramePlugin()]


def plugins_events() -> List[Any]:
    from waveformanalysis_tpu_torch.plugins.builtin.event_analysis import (
        EventHitsPlugin,
        EventsPlugin,
        GroupedEventsPlugin,
        HitGroupedPlugin,
        PairedEventsPlugin,
    )

    return [GroupedEventsPlugin(), EventsPlugin(), EventHitsPlugin(),
            HitGroupedPlugin(), PairedEventsPlugin()]


PLUGIN_SETS: Dict[str, Callable[[], List[Any]]] = {
    "io": plugins_io,
    "waveform": plugins_waveform,
    "records": plugins_records,
    "peaks": plugins_peaks,
    "basic_features": plugins_basic_features,
    "classification": plugins_classification,
    "tabular": plugins_tabular,
    "events": plugins_events,
}


def get_plugin_set(name: str) -> List[Any]:
    if name not in PLUGIN_SETS:
        raise KeyError(f"Unknown plugin set {name!r}; available: {sorted(PLUGIN_SETS)}")
    return PLUGIN_SETS[name]()


def cuda_default() -> List[Any]:
    """The full pipeline on the Context's device (the JAX package's
    ``tpu_default``, reference analog: profiles.cpu_default)."""
    out: List[Any] = []
    for name in ("io", "waveform", "records", "peaks", "basic_features",
                 "classification", "tabular", "events"):
        out.extend(PLUGIN_SETS[name]())
    return out


def cpu_default() -> List[Any]:
    """Alias for the default profile (reference API parity: the device is
    the Context's, so ``cpu`` names the same plugins)."""
    return cuda_default()


def streaming_default() -> List[Any]:
    """Full pipeline + the chunked streaming plugin family: the default
    profile plus ``signal_peaks_stream``, with the device chunk executor
    available via ``StreamingContext.get_stream(..., executor_type="device")``
    for every derivable static name."""
    from waveformanalysis_tpu_torch.plugins.builtin.signal_peaks import (
        SignalPeaksStreamPlugin,
    )

    return cuda_default() + [SignalPeaksStreamPlugin()]


PROFILES: Dict[str, Callable[[], List[Any]]] = {
    "cuda": cuda_default,
    "cuda_default": cuda_default,
    "cpu": cpu_default,
    "cpu_default": cpu_default,
    "default": cuda_default,
    "streaming": streaming_default,
    "streaming_default": streaming_default,
}


def get_profile(name: str) -> List[Any]:
    if name not in PROFILES:
        raise KeyError(f"Unknown profile {name!r}; available: {sorted(PROFILES)}")
    return PROFILES[name]()
