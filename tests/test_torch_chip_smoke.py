"""The host-side helpers of chip_smoke.py, on the CPU: the ptxas report its
build phase prints, the relative error its kernel checks use, and the
trainer phase's check that its own workers are gone after shutdown."""

import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_bwd_wgmma_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd022flash_bwd_wgmma_kernelILi128EEEv14CUtensorMap_st
    664 bytes stack frame, 1428 bytes spill stores, 1428 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 664 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c4b42d03_18_flash_attention_cu_b294bfd027flash_bwd_dq_convert_kernelEPK6float4P5uint2m' for 'sm_90a'
ptxas info    : Used 14 registers, 8 bytes smem, 380 bytes cmem[0]
"""


def test_ptxas_report_names_each_kernel():
    report = chip_smoke.ptxas_report(LOG)
    assert report["flash_fwd_wgmma_kernel<64>"] == {
        "spill_store_load_bytes": [0, 0], "registers": 167, "static_smem_bytes": 0}
    assert report["flash_bwd_wgmma_kernel<128>"]["spill_store_load_bytes"] == [1428, 1428]
    assert report["flash_bwd_dq_convert_kernel"] == {"registers": 14, "static_smem_bytes": 8}


@pytest.mark.parametrize("floor,expected", [(0.0, 0.5), (4.0, 0.25)])
def test_rel_err_floor(floor, expected):
    # ||a - b|| / max(||b||, floor): a floor only matters where b is near zero.
    b = torch.tensor([2.0, 0.0])
    a = torch.tensor([3.0, 0.0])
    assert chip_smoke.rel_err(a, b, floor) == pytest.approx(expected)


def test_trainer_cleanup_check_sees_only_this_runs_workers():
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        class Pid:
            def pid(self):
                return os.getpid()

        pid = ray_tpu_torch.get(Pid.remote().pid.remote())
        pids = chip_smoke.runtime_worker_pids()
        assert pid in pids and all(chip_smoke.pid_alive(p) for p in pids)
        assert not chip_smoke.pid_alive(-1)
    finally:
        ray_tpu_torch.shutdown()
    deadline = time.time() + 10
    while any(chip_smoke.pid_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(chip_smoke.pid_alive(p) for p in pids)
