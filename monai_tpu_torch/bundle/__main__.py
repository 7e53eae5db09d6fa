"""``python -m monai_tpu_torch.bundle <verb> [--key value ...]`` (counterpart of
monai_tpu/bundle/__main__.py): the verbs ``run``, ``run_workflow``, ``download``, ``load``,
``ckpt_export``, ``verify_metadata``, ``verify_net_in_out`` and ``init_bundle`` of
``scripts``. Each ``--key value``
becomes a keyword: an int, a float, ``true``/``false``, JSON (a list or a dict), or
else the string as it is; a last ``--key`` without a value is ``true``."""
from __future__ import annotations

import json
import sys

from monai_tpu_torch.bundle.scripts import (ckpt_export, download, init_bundle, load, run, run_workflow,
                                            verify_metadata, verify_net_in_out)

VERBS = {
    "run": run,
    "run_workflow": run_workflow,
    "download": download,
    "load": load,
    "ckpt_export": ckpt_export,
    "verify_metadata": verify_metadata,
    "verify_net_in_out": verify_net_in_out,
    "init_bundle": init_bundle,
}


def _parse(value: str):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    try:
        return json.loads(value)
    except ValueError:
        return value


def parse_args(argv: list[str]) -> tuple[list, dict]:
    """The positional arguments and keywords of a verb's command line."""
    args, kwargs = [], {}
    it = iter(argv)
    for tok in it:
        if tok.startswith("--"):
            kwargs[tok[2:]] = _parse(next(it, "true"))
        else:
            args.append(_parse(tok))
    return args, kwargs


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in VERBS:
        print(f"usage: python -m monai_tpu_torch.bundle <verb> [--key value ...]\nverbs: {sorted(VERBS)}")
        return
    args, kwargs = parse_args(argv[1:])
    VERBS[argv[0]](*args, **kwargs)


if __name__ == "__main__":
    main()
