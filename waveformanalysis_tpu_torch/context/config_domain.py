"""Context config domain: per-run run_config loading and hash tracking.

Behavioral analog of the reference config domain
(reference: waveform_analysis/core/context_config.py:166-434): a per-run
``run_config.json`` (path template-able) carries plugin blocks
(``run_config["plugins"][name]``) and hardware channel metadata
(``channel_metadata``); its hash is tracked so a changed file invalidates
that run's cached state before the next request.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

DEFAULT_RUN_CONFIG_TEMPLATE = "{data_root}/{run_id}/run_config.json"


class ConfigDomain:
    """Run-config loading, hashing, and request preparation."""

    def __init__(self, context: Any) -> None:
        self.ctx = context
        self._run_configs: Dict[str, Optional[Dict[str, Any]]] = {}
        self._run_config_hashes: Dict[str, Optional[str]] = {}

    # -- run config ----------------------------------------------------------

    def run_config_path(self, run_id: str) -> Optional[str]:
        template = self.ctx.config.get(
            "run_config_path_template", DEFAULT_RUN_CONFIG_TEMPLATE
        )
        data_root = self.ctx.config.get("data_root")
        if "{data_root}" in template and not data_root:
            return None
        try:
            return template.format(data_root=data_root, run_id=run_id)
        except (KeyError, IndexError):
            logger.warning("Invalid run_config_path_template: %r", template)
            return None

    def load_run_config(self, run_id: str, force: bool = False) -> Optional[Dict[str, Any]]:
        if not force and run_id in self._run_configs:
            return self._run_configs[run_id]
        path = self.run_config_path(run_id)
        cfg = None
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    cfg = json.load(fh)
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("Failed to load run config %s: %s", path, e)
        self._run_configs[run_id] = cfg
        return cfg

    def get_run_config(self, run_id: str) -> Optional[Dict[str, Any]]:
        return self.load_run_config(run_id)

    def get_plugin_run_config(self, run_id: str, plugin_name: str) -> Dict[str, Any]:
        cfg = self.load_run_config(run_id)
        if not cfg:
            return {}
        plugins_block = cfg.get("plugins", {})
        block = plugins_block.get(plugin_name, {})
        return dict(block) if isinstance(block, dict) else {}

    def compute_run_config_hash(self, run_id: str) -> Optional[str]:
        cfg = self.load_run_config(run_id)
        if cfg is None:
            return None
        blob = json.dumps(cfg, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    # -- request preparation -------------------------------------------------

    def run_config_roots(self) -> list:
        """Registered plugins whose outputs depend on run_config content
        (``uses_run_config``); their downstream cones are the invalidation
        targets (reference: context_config.py:312-330)."""
        return [
            name for name, plugin in self.ctx._plugins.items()
            if bool(getattr(plugin, "uses_run_config", False))
        ]

    def _hash_state_path(self, run_id: str) -> Optional[str]:
        root = getattr(self.ctx, "storage_dir", None)
        if not root:
            return None
        return os.path.join(str(root), run_id, "_run_config_state.json")

    def _load_persisted_state(self, run_id: str) -> Dict[str, Any]:
        path = self._hash_state_path(run_id)
        if not path or not os.path.exists(path):
            return {}
        try:
            with open(path) as fh:
                state = json.load(fh)
            return state if isinstance(state, dict) else {}
        except (OSError, json.JSONDecodeError):
            return {}

    @staticmethod
    def _plugin_block_names(cfg: Optional[Dict[str, Any]]) -> list:
        block = (cfg or {}).get("plugins")
        return sorted(block) if isinstance(block, dict) else []

    def _persist_hash(self, run_id: str, value: Optional[str]) -> None:
        path = self._hash_state_path(run_id)
        if not path:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                # plugin_roots: the plugins-block names at save time, so a
                # later process can invalidate entries whose block was
                # REMOVED (the old config is otherwise unknown to it)
                json.dump({
                    "hash": value,
                    "path": self.run_config_path(run_id),
                    "plugin_roots": self._plugin_block_names(
                        self._run_configs.get(run_id)
                    ),
                }, fh)
            os.replace(tmp, path)
        except OSError as e:  # pragma: no cover - fs failures
            logger.warning("Failed to persist run_config hash: %s", e)

    def prepare_request(self, run_id: str) -> None:
        """Reload run config; if its hash changed, invalidate the run's caches.

        The previous hash is PERSISTED next to the run's cached data
        (reference: context_config.py:258-311 save_run_config_hash), so a
        run_config edited between processes also invalidates: disk caches of
        every ``uses_run_config`` root plugin and its downstream cone are
        cleared, not just this process's memory entries.
        """
        prev_hash = self._run_config_hashes.get(run_id)
        first_sight = run_id not in self._run_config_hashes
        prev_cfg = self._run_configs.get(run_id)
        prev_block_names: list = self._plugin_block_names(prev_cfg)
        self.load_run_config(run_id, force=True)
        new_hash = self.compute_run_config_hash(run_id)
        if first_sight:
            state = self._load_persisted_state(run_id)
            prev_hash = state.get("hash")
            prev_block_names = list(state.get("plugin_roots") or [])
            if prev_hash is None:
                # nothing recorded before (new run, or pre-feature caches):
                # record without invalidating (reference: previous None ->
                # save and return, context_config.py maybe_invalidate)
                self._run_config_hashes[run_id] = new_hash
                if new_hash is not None:
                    self._persist_hash(run_id, new_hash)
                return
        if not first_sight and prev_hash == new_hash:
            return
        if prev_hash != new_hash:
            logger.info(
                "run_config changed for run %s (%s -> %s); invalidating caches",
                run_id, prev_hash, new_hash,
            )
            self.ctx.cache_domain.clear_performance_caches()
            # memory AND disk caches of run_config-dependent roots and
            # everything below; manually injected inputs and plugins with no
            # run_config dependence keep their caches (reference:
            # invalidate_run_config_related_cache, context_config.py:319).
            # Roots = uses_run_config plugins PLUS any plugin named in the
            # old or new run_config "plugins" block — those blocks feed
            # _effective_config for every plugin, marked or not.
            roots = set(self.run_config_roots())
            block_names = set(prev_block_names)
            block_names.update(
                self._plugin_block_names(self._run_configs.get(run_id))
            )
            roots.update(n for n in block_names if n in self.ctx._plugins)
            for root in sorted(roots):
                try:
                    self.ctx.cache_domain.clear_cache_for(
                        run_id, root, downstream=True
                    )
                except Exception as e:  # pragma: no cover - defensive
                    logger.warning(
                        "Failed clearing run_config-dependent cache for "
                        "(%s, %s): %s", run_id, root, e,
                    )
        self._run_config_hashes[run_id] = new_hash
        self._persist_hash(run_id, new_hash)

    def invalidate_run(self, run_id: str) -> None:
        self._run_configs.pop(run_id, None)
        self._run_config_hashes.pop(run_id, None)
