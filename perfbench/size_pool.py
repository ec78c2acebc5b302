"""Size a configuration's page pool on the card, once.

    python3 perfbench/size_pool.py --config <name> [--write]

Builds the configuration's engines with a pool just large enough for
every lane at ``max_len``, warms the cell's shapes (one full prefill
chunk and one decode round per engine), and reads the workspace: the
peak allocated bytes net of the weights and the pools.  The pool then
holds what ``memory_fraction`` of the card leaves after every engine's
weights and that workspace, split evenly over the engines (vLLM's
``gpu_memory_utilization`` rule).  Prints the reading as JSON;
``--write`` stores ``num_pages`` in the configuration file.  The bytes
of the weights and of a page are the configuration's model kind's
(``weight_bytes``, ``page_bytes``).
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def plan(kind, spec, sv, small: int, peak: int, total: int) -> dict:
    """The pool of ``sv`` (the configuration's ``serve`` block) from the
    peak allocated bytes of engines sized at ``small`` pages and the
    card's ``total`` bytes."""
    E = sv["engines"]
    weights = E * kind.weight_bytes(spec)
    pools = E * small * kind.page_bytes(spec, sv["page_size"])
    workspace = peak - weights - pools
    budget = sv["memory_fraction"] * total - weights - workspace
    pages = int(budget // E // kind.page_bytes(spec, sv["page_size"]))
    return {"total_bytes": total, "weight_bytes": weights,
            "pool_bytes_at_sizing": pools, "peak_bytes": peak,
            "workspace_bytes": workspace, "num_pages": pages,
            "tokens_per_engine": pages * sv["page_size"],
            "sizing_pages": small}


def main() -> None:
    import torch

    from perfbench import harness, model
    from repro_torch.serving.paged_kv import cdiv

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    path = harness.HERE / "configs" / f"{args.config}.json"
    conf = model.load(path)
    sv = conf["serve"]
    small = 1 + sv["lanes"] * cdiv(sv["max_len"], sv["page_size"])
    cell = harness.Cell(conf["name"], 1, conf, {}, {}, [], [])
    opts = harness.Options(seed=0, seconds=0.0, num_pages=small)
    served = harness.setup(cell, opts)
    torch.cuda.synchronize()
    out = {"config": conf["name"], "card": torch.cuda.get_device_name(0),
           **plan(cell.kind, served.spec, sv, small,
                  torch.cuda.max_memory_allocated(),
                  torch.cuda.get_device_properties(0).total_memory)}
    pages = out["num_pages"]
    print(json.dumps(out))
    del served
    if args.write:
        conf["serve"]["num_pages"] = pages
        path.write_text(json.dumps(conf, indent=2) + "\n")


if __name__ == "__main__":
    main()
