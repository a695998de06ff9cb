"""``BeaconConfig.dumps`` of the port held against the JAX package's.

Both write ``dataclasses.asdict`` of the config as indented JSON with the
storage root as a string. The port's engine section lacks nine knobs of
the JAX package (``JAX_ONLY_ENGINE``: XLA batch tiers, the TPU switch,
the pod tier's layout switches, engine-side ingest sizing and the plane
upload chunk); with those taken out of the JAX
document, the two texts are equal once their keys are sorted.
"""

import json
from pathlib import Path

import pytest

from sbeacon_tpu.config import BeaconConfig as JBeaconConfig
from sbeacon_tpu.config import StorageConfig as JStorageConfig
from sbeacon_tpu_torch.config import BeaconConfig, StorageConfig

JAX_ONLY_ENGINE = {
    "batch_size", "ingest_shard_bytes",
    "ingest_workers", "mesh_axis", "mesh_owner_outputs", "mesh_planes",
    "mesh_slice", "plane_upload_chunk_mb", "use_tpu",
}


def _canonical(doc: dict) -> str:
    return json.dumps(doc, indent=2, sort_keys=True)


@pytest.mark.parametrize("root", [None, "/srv/beacon-data"])
def test_dumps_matches_jax(root):
    if root is None:
        tcfg, jcfg = BeaconConfig(), JBeaconConfig()
    else:
        tcfg = BeaconConfig(storage=StorageConfig(root=Path(root)))
        jcfg = JBeaconConfig(storage=JStorageConfig(root=Path(root)))
    text = tcfg.dumps()
    got = json.loads(text)
    assert text == json.dumps(got, indent=2)
    assert got["storage"]["root"] == str(tcfg.storage.root)
    want = json.loads(jcfg.dumps())
    assert set(want["engine"]) - set(got["engine"]) == JAX_ONLY_ENGINE
    for k in JAX_ONLY_ENGINE:
        del want["engine"][k]
    assert _canonical(got) == _canonical(want)
