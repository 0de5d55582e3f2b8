"""Environment-variable configuration tier (reference constants.py:7-23,
30-54, 244-258).

The reference resolves its directory layout from environment variables
(populated from a ``.env`` file by its docker-compose ``env_file``,
reference docker-compose.yaml:3-123) through ``load_from_env`` and dumps
them with ``log_env_variables``.  This module reproduces that tier:

  * ``load_dotenv(path)`` — minimal KEY=VALUE parser (no external
    dependency; the compose file's env_file semantics: existing process
    environment wins unless ``override=True``),
  * ``load_from_env(name, type, default)`` — typed lookup with the
    reference's bool coercion and missing-without-default error,
  * ``env_settings()`` / ``log_env_variables()`` — the canonical
    directory map used by main.py / scripts.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

#: directory/env-var surface of the reference (constants.py:32-54)
ENV_DEFAULTS = {
    "CONFIG_FILE_PATH": None,  # resolved by callers (packaged example)
    "CHECKPOINTS_DIR": "checkpoints",
    "TRAIN_DATA_DIR": "train_data",
    "RESULTS_DIR": "results",
    "LOG_DIR": "logs",
    "DATASETS_DIR": "datasets",
}


def load_dotenv(path: str = ".env", override: bool = False) -> Dict[str, str]:
    """Parse a ``.env`` file of KEY=VALUE lines into os.environ.

    Quietly does nothing when the file is absent (the reference runs
    without one outside compose).  Lines starting with '#' and blank
    lines are skipped; surrounding single/double quotes are stripped;
    an optional leading ``export `` is accepted.  Returns the parsed
    mapping."""
    parsed: Dict[str, str] = {}
    if not os.path.exists(path):
        return parsed
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
                value = value[1:-1]
            parsed[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    logger.info("loaded %d variables from %s", len(parsed), path)
    return parsed


def load_from_env(env_var_name: str, data_type: Callable = str, default=None):
    """Typed environment lookup (reference constants.py:7-23): empty
    values fall through to the default; bools compare 'true'
    case-insensitively; a missing variable WITHOUT a default raises."""
    if env_var_name in os.environ and os.environ[env_var_name] != "":
        value = os.environ[env_var_name]
        if data_type is bool:
            return value.lower() == "true"
        return data_type(value)
    if env_var_name not in os.environ and default is None:
        raise ValueError(
            f"Could not find environment variable '{env_var_name}'. "
            f"Please check the .env file or provide a default value."
        )
    return default


def env_settings(repo_dir: Optional[str] = None) -> Dict[str, str]:
    """Resolve the canonical directory map, rooted at ``repo_dir`` when
    the env values are relative (reference constants.py:30-54 joins
    everything onto REPO_DIR)."""
    root = repo_dir or os.getcwd()
    out: Dict[str, str] = {}
    for name, default in ENV_DEFAULTS.items():
        value = load_from_env(name, str, default if default is not None else "")
        if value and not os.path.isabs(value) and name != "CONFIG_FILE_PATH":
            value = os.path.join(root, value)
        out[name] = value
    return out


def log_env_variables(repo_dir: Optional[str] = None) -> Dict[str, str]:
    """Log the resolved environment (reference constants.py:244-258)."""
    settings = env_settings(repo_dir)
    logger.info("Environment variables:")
    for name, value in settings.items():
        logger.info("%s: %s", name, value)
    return settings
