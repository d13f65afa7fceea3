"""Plugin documentation generator.

Behavioral analog of the reference doc generator
(reference: waveform_analysis/utils/plugin_doc_generator.py:113 and
templates/*.j2): renders one markdown page per plugin from its PluginSpec —
a human variant (prose + tables) and an agent variant (terse, machine-
oriented) — plus an index page.

Port of ``waveformanalysis_tpu/utils/plugin_doc_generator.py``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Union

from waveformanalysis_tpu_torch.plugins.base import Plugin
from waveformanalysis_tpu_torch.plugins.spec import PluginSpec

logger = logging.getLogger(__name__)

HUMAN_TEMPLATE = """\
# `{{ spec.provides }}` — {{ spec.name }}

{{ spec.description or "(no description)" }}

- **version:** {{ spec.version }}
- **depends on:** {% if spec.depends_on %}{% for d in spec.depends_on %}`{{ d.name }}`{{ ", " if not loop.last }}{% endfor %}{% elif dynamic_deps %}(dynamic, resolved from config){% else %}nothing (source plugin){% endif %}
- **save policy:** {{ save_when }}
- **device kernel:** {{ "yes" if spec.capabilities.device_kernel else "no" }}
- **streaming:** {{ "yes" if spec.capabilities.supports_streaming else "no" }}

## Configuration

{% if spec.config_spec %}
| option | type | default | tracked | description |
|---|---|---|---|---|
{% for name, cf in spec.config_spec.items() -%}
| `{{ name }}` | {{ cf.type }} | `{{ cf.default }}` | {{ "yes" if cf.tracked else "no" }} | {{ cf.doc }} |
{% endfor %}
{% else %}
_No options._
{% endif %}

## Output schema

{% if spec.output_schema and spec.output_schema.fields %}
| field | dtype | shape | unit | description |
|---|---|---|---|---|
{% for f in spec.output_schema.fields -%}
| `{{ f.name }}` | {{ f.dtype }} | {{ f.shape or "scalar" }} | {{ f.unit }} | {{ f.doc }} |
{% endfor %}
{% else %}
_Unstructured output ({{ output_dtype }})._
{% endif %}
"""

AGENT_TEMPLATE = """\
PLUGIN {{ spec.provides }}
class={{ spec.name }} version={{ spec.version }} save_when={{ save_when }}
depends_on={{ dep_names }}
options={{ option_lines }}
output_fields={{ field_names }}
spec_hash={{ spec_hash }}
"""


class PluginDocGenerator:
    """Renders markdown documentation for registered plugins."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        import jinja2

        self._env = jinja2.Environment(keep_trailing_newline=True)
        self._human = self._env.from_string(HUMAN_TEMPLATE)
        self._agent = self._env.from_string(AGENT_TEMPLATE)

    def _spec_for(self, plugin: Plugin) -> PluginSpec:
        return plugin._validated_spec or PluginSpec.from_plugin(plugin)

    def render_plugin(self, data_name: str, variant: str = "human") -> str:
        plugin = self.ctx.get_plugin(data_name)
        if plugin is None:
            raise KeyError(f"No plugin registered for '{data_name}'")
        spec = self._spec_for(plugin)
        if variant == "human":
            from waveformanalysis_tpu_torch.plugins.base import Plugin as _P

            dynamic = type(plugin).resolve_depends_on is not _P.resolve_depends_on
            return self._human.render(
                spec=spec,
                save_when=plugin.save_when,
                output_dtype=str(plugin.output_dtype),
                dynamic_deps=dynamic,
            )
        if variant == "agent":
            return self._agent.render(
                spec=spec,
                save_when=plugin.save_when,
                dep_names=[d.name for d in spec.depends_on],
                option_lines={k: cf.default for k, cf in spec.config_spec.items()},
                field_names=[f.name for f in (spec.output_schema.fields
                                              if spec.output_schema else [])],
                spec_hash=spec.spec_hash(),
            )
        raise ValueError(f"Unknown doc variant {variant!r}; use human|agent")

    def render_index(self) -> str:
        lines = ["# Plugin reference", "", "| provides | class | version | description |",
                 "|---|---|---|---|"]
        for name in sorted(self.ctx.plugins):
            plugin = self.ctx.get_plugin(name)
            lines.append(
                f"| [`{name}`]({name}.md) | {type(plugin).__name__} "
                f"| {plugin.version} | {plugin.description[:80]} |"
            )
        return "\n".join(lines) + "\n"

    def generate_all(
        self, out_dir: Union[str, Path], variant: str = "human"
    ) -> Dict[str, Path]:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        written: Dict[str, Path] = {}
        for name in sorted(self.ctx.plugins):
            path = out_dir / f"{name}.md"
            path.write_text(self.render_plugin(name, variant=variant))
            written[name] = path
        index = out_dir / "index.md"
        index.write_text(self.render_index())
        written["__index__"] = index
        return written


def check_doc_coverage(
    context: Any, doc_dir: Union[str, Path], variant: str = "human"
) -> Dict[str, Any]:
    """Doc drift checker (reference: utils/doc_coverage.py:83): every plugin
    must have an up-to-date page; returns {missing, stale, ok}."""
    doc_dir = Path(doc_dir)
    gen = PluginDocGenerator(context)
    report: Dict[str, List[str]] = {"missing": [], "stale": [], "ok": []}
    for name in sorted(context.plugins):
        path = doc_dir / f"{name}.md"
        if not path.exists():
            report["missing"].append(name)
            continue
        expected = gen.render_plugin(name, variant=variant)
        if path.read_text() != expected:
            report["stale"].append(name)
        else:
            report["ok"].append(name)
    report["is_complete"] = not (report["missing"] or report["stale"])
    return report
