"""Config generator (a copy of ``kair_tpu/cli/config_generator.py``, pure
Python) — the fork's SPECToptions/config_generator.py (208 LoC):
expand a base template with ``{{PLACEHOLDER}}`` slots using
experiment_configs.json entries and splice in the named network config from
network_configs.json.

    python -m kair_tpu_torch.cli.config_generator \
        --template base_template.json --networks network_configs.json \
        --experiments experiment_configs.json --out generated/ [--only NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Any, Dict


def remove_json_comments(text: str) -> str:
    """Strip // comments and trailing commas (reference :13-20)."""
    text = re.sub(r"//.*?(?=\n|$)", "", text)
    text = re.sub(r",\s*}", "}", text)
    text = re.sub(r",\s*]", "]", text)
    return text


def _value_str(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    return json.dumps(v)


def generate_config(template: str, experiment: Dict[str, Any],
                    network_configs: Dict[str, Any]) -> str:
    """Fill placeholders; '"{{NETWORK_CONFIG}}"' becomes the full netG JSON
    object (reference :11-49)."""
    config = template
    net_name = experiment.get("NETWORK_CONFIG")
    if net_name is not None:
        net_json = json.dumps(network_configs[net_name], indent=2,
                              ensure_ascii=False)
        config = config.replace('"{{NETWORK_CONFIG}}"', net_json)
    for key, value in experiment.items():
        if key == "NETWORK_CONFIG":
            continue
        config = config.replace(f'"{{{{{key}}}}}"', _value_str(value))
    return config


def generate_all(template_path: str, networks_path: str,
                 experiments_path: str, out_dir: str,
                 only: str = None) -> Dict[str, str]:
    with open(template_path, encoding="utf-8") as f:
        template = f.read()
    with open(networks_path, encoding="utf-8") as f:
        networks = json.loads(remove_json_comments(f.read()))
    with open(experiments_path, encoding="utf-8") as f:
        experiments = json.loads(remove_json_comments(f.read()))["experiments"]

    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for name, exp in experiments.items():
        if only and name != only:
            continue
        cfg = generate_config(template, exp, networks)
        # validate it parses after comment stripping
        json.loads(remove_json_comments(cfg))
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            f.write(cfg)
        written[name] = path
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--template", required=True)
    p.add_argument("--networks", required=True)
    p.add_argument("--experiments", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--only", default=None)
    args = p.parse_args(argv)
    written = generate_all(args.template, args.networks, args.experiments,
                           args.out, args.only)
    for name, path in written.items():
        print(f"generated {name} -> {path}")


if __name__ == "__main__":
    main()
