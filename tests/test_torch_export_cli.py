"""The exported serving step without MIPS, against the JAX package, and the
``export`` subcommand (tests/test_torch_export.py holds the Flat and IVF SQ8
stores, the positions and the custom ops' fakes).

`run_export(device="cpu")` on configs/no_mips.yaml: the loaded artifact
serves ids equal to the port's eager ``generate(rag_encode(...))``, and,
served with the JAX package's parameters (`bridge.load_jax_params`), the JAX
package's ``generate(rag_encode(...))`` ids.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from retrieval_augmented_mds_tpu.models import generate as jgen
from retrieval_augmented_mds_tpu.models import retriever_generator as jrag
from retrieval_augmented_mds_tpu.utils import config as jconfig
from retrieval_augmented_mds_tpu_torch import cli, serving

from tests.test_torch_export import REPO, check_served_ids, exported  # noqa: F401
from tests.test_torch_models import port_params


@pytest.mark.parametrize("exported", ["no_mips"], indirect=True)
def test_exported_artifact_serves_the_eager_ids(exported):
    check_served_ids(*exported)


@pytest.mark.parametrize("exported", ["no_mips"], indirect=True)
def test_exported_ids_equal_jax(exported):
    """The artifact, served with the JAX package's parameters loaded into the
    port's model, gives the JAX package's ``generate(rag_encode(...))`` ids
    on the same parameters and batch (beam 1, 16 tokens)."""
    cfg, art, _, report = exported
    jcfg = jconfig.load_config(os.path.join(REPO, "configs", "no_mips.yaml"))
    jp = jrag.init_rag(jax.random.PRNGKey(3), jcfg.model)
    batch = report["batch"]
    jenc = jrag.rag_encode(jp, jcfg.model, None,
                           {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    jids = np.asarray(jgen.generate(jp, jcfg.model, jenc, jcfg.generation))
    ids = serving.serve(art, port_params(cfg.model, jp), None, batch)
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_export_cli_writes_the_artifact(tmp_path, capsys):
    """``python -m ... cli export --config configs/no_mips.yaml --device cpu
    --out DIR`` prints the manifest and writes the three files."""
    out = str(tmp_path / "art")
    assert cli.main(["export", "--config", os.path.join(REPO, "configs", "no_mips.yaml"),
                     "--device", "cpu", "--out", out]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["artifact"] == [os.path.join(out, serving.ENCODE),
                                   os.path.join(out, serving.DECODE_STEP)]
    assert {serving.ENCODE, serving.DECODE_STEP, serving.MANIFEST} <= set(os.listdir(out))
