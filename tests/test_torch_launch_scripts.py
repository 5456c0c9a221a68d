"""The port's launch scripts (``infinisst_tpu_torch/scripts/``), the
counterparts of the root ``scripts/``: every flag of each script's
command parses with the port's own parser (``train.main.parse_args``,
the CLI's ``add_args``), the values are the root script's, and the
launcher is ``torchrun`` over 8 processes (training) or one ``python``
(inference)."""

import argparse
import os
import re
import shlex

import pytest

from infinisst_tpu_torch.agents import cli
from infinisst_tpu_torch.train import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "infinisst_tpu_torch", "scripts")
SCRIPTS = {  # port script -> (root script, module)
    "train/stage1.sh": ("train/stage1.sh", "infinisst_tpu_torch.train.main"),
    "train/stage2.sh": ("train/stage2.sh", "infinisst_tpu_torch.train.main"),
    "infer/infinisst.sh": ("infer/infinisst.sh",
                           "infinisst_tpu_torch.agents.cli"),
    "infer/streamatt.sh": ("infer/streamatt.sh",
                           "infinisst_tpu_torch.agents.cli"),
}
ENV = dict(llama_path="/m/llama", w2v2_path="/m/w2v2.pt", data_path="/d",
           save_dir="runs/x", lang="German", stage1_bin="/m/s1.bin",
           ckpt="/m/ckpt.bin", data="/d", mult="2", tok="13a", unit="word",
           frame="1", agent="streamatt")


def command(path: str):
    """The script's command as argv: its continued lines joined, the
    shell variables substituted."""
    text = open(path).read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if re.match(r"\s*(torchrun|python) ", ln))
    line = re.sub(r"\$\{(\w+)\}", lambda m: ENV[m.group(1)], line)
    return shlex.split(line)


def _flags(argv):
    return {a for a in argv if a.startswith("--")}


def cli_parser():
    p = argparse.ArgumentParser()
    cli.add_args(p)
    return p


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_parses_with_the_port_parser(name):
    root_name, module = SCRIPTS[name]
    argv = command(os.path.join(PORT, name))
    m = argv.index("-m")
    assert argv[m + 1] == module
    args = argv[m + 2:]
    if module.endswith("train.main"):
        assert argv[:4] == ["torchrun", "--standalone", "--nproc_per_node",
                            "8"]
        ns = train_main.parse_args(args)
        assert ns.n_data * ns.n_model == 8 and ns.zero is True
        assert ns.stage == int(name[-4])
    else:
        assert argv[0] == "python"
        ns = cli_parser().parse_args(args)
        assert ns.beam == 4 and ns.repetition_penalty == 1.2
    # the root script's flags, each one, with the root script's values
    root = command(os.path.join(ROOT, "scripts", root_name))
    rargs = root[root.index("-m") + 2:]
    assert _flags(args) == _flags(rargs)
    assert args == rargs
