# Copy of masp_tpu/r1cs/gadgets/uint32.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""UInt32 gadget (bellman gadgets::uint32): 32 little-endian Booleans.

``addmany`` routes its equality through a MultiEq so several adders pack into
one R1CS row — this is what keeps the in-circuit BLAKE2s at ~21k constraints.
"""

from __future__ import annotations

from masp_tpu_torch.host.r1cs import wit
from masp_tpu_torch.host.r1cs.cs import MultiEq, lc
from masp_tpu_torch.host.r1cs.gadgets.boolean import AllocatedBit, Boolean


class UInt32:
    __slots__ = ("bits", "value")

    def __init__(self, bits: list[Boolean], value: int | None):
        assert len(bits) == 32
        self.bits = bits
        self.value = value

    @staticmethod
    def constant(value: int) -> "UInt32":
        value &= 0xFFFFFFFF
        bits = [Boolean.constant((value >> i) & 1 == 1) for i in range(32)]
        return UInt32(bits, value)

    @staticmethod
    def from_bits(bits: list[Boolean]) -> "UInt32":
        """bits in little-endian order."""
        assert len(bits) == 32
        value = 0
        for i, b in enumerate(bits):
            v = b.get_value()
            if v is None:
                value = None
                break
            # bits are disjoint, so |= is plain addition (tape-friendly)
            value = value + wit.as_bit(v) * (1 << i) if wit.is_tape(v) else (
                value | (1 << i) if v else value
            )
        return UInt32(list(bits), value)

    def into_bits(self) -> list[Boolean]:
        return list(self.bits)

    def xor(self, cs, other: "UInt32") -> "UInt32":
        value = None
        if self.value is not None and other.value is not None:
            value = self.value ^ other.value
        bits = []
        for i, (a, b) in enumerate(zip(self.bits, other.bits)):
            with cs.ns(f"xor of bit {i}"):
                bits.append(Boolean.xor(cs, a, b))
        return UInt32(bits, value)

    def rotr(self, by: int) -> "UInt32":
        by %= 32
        bits = [self.bits[(i + by) % 32] for i in range(32)]
        value = None
        if self.value is not None:
            value = ((self.value >> by) | (self.value << (32 - by))) & 0xFFFFFFFF
        return UInt32(bits, value)

    def shr(self, by: int) -> "UInt32":
        fill = Boolean.constant(False)
        bits = [self.bits[i + by] if i + by < 32 else fill for i in range(32)]
        value = None if self.value is None else (self.value >> by)
        return UInt32(bits, value)

    @staticmethod
    def addmany(meq: MultiEq, operands: list["UInt32"]) -> "UInt32":
        """Modular addition of 2..10 operands; equality enforced through the
        MultiEq packer."""
        assert 2 <= len(operands) <= 10
        cs = meq  # MultiEq passes alloc/enforce through

        max_value = len(operands) * 0xFFFFFFFF
        result_value: int | None = 0
        lhs = lc()
        all_constants = True

        for op in operands:
            if op.value is None:
                result_value = None
            elif result_value is not None:
                result_value += op.value
            coeff = 1
            for bit in op.bits:
                if bit.kind == Boolean.IS:
                    all_constants = False
                    lhs.add_term(bit.bit.var, coeff)
                elif bit.kind == Boolean.NOT:
                    all_constants = False
                    lhs.add_term(cs.one(), coeff)
                    lhs.add_term(bit.bit.var, -coeff)
                else:
                    if bit.const:
                        lhs.add_term(cs.one(), coeff)
                coeff <<= 1

        modular_value = None if result_value is None else result_value & 0xFFFFFFFF
        if all_constants and modular_value is not None:
            return UInt32.constant(modular_value)

        result_bits: list[Boolean] = []
        result_lc = lc()
        coeff = 1
        i = 0
        mv = max_value
        while mv != 0:
            bval = None if result_value is None else wit.bit(result_value, i)
            with cs.ns(f"result bit {i}"):
                b = AllocatedBit.alloc(cs, bval)
            result_lc.add_term(b.var, coeff)
            result_bits.append(Boolean.from_bit(b))
            mv >>= 1
            i += 1
            coeff <<= 1

        meq.enforce_equal(i, lhs, result_lc)
        result_bits = result_bits[:32]
        return UInt32(result_bits, modular_value)


__all__ = ["UInt32"]
