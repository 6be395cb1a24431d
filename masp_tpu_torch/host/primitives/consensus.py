# Copy of masp_tpu/primitives/consensus.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Consensus parameters (masp_primitives/src/consensus.rs): networks,
activation heights, branch ids."""

from __future__ import annotations


class NetworkUpgrade:
    MASP = "MASP"


class BranchId:
    MASP = 0xE9FF75A6

    @staticmethod
    def try_from(value: int) -> int:
        if value == BranchId.MASP:
            return BranchId.MASP
        raise ValueError("unknown consensus branch id")

    @staticmethod
    def for_height(params: "Parameters", height: int) -> int:
        return BranchId.MASP


class Parameters:
    """Network parameter trait."""

    def activation_height(self, nu: str) -> int | None:
        raise NotImplementedError

    def is_nu_active(self, nu: str, height: int) -> bool:
        h = self.activation_height(nu)
        return h is not None and h <= height


class MainNetwork(Parameters):
    def activation_height(self, nu: str) -> int | None:
        if nu == NetworkUpgrade.MASP:
            return 0
        return None


class TestNetwork(Parameters):
    def activation_height(self, nu: str) -> int | None:
        if nu == NetworkUpgrade.MASP:
            # Activate MASP at height 1 so pre-ZIP-212 tests work at height 0
            return 1
        return None


MAIN_NETWORK = MainNetwork()
TEST_NETWORK = TestNetwork()
H0 = 0

__all__ = [
    "NetworkUpgrade", "BranchId", "Parameters", "MainNetwork", "TestNetwork",
    "MAIN_NETWORK", "TEST_NETWORK", "H0",
]
