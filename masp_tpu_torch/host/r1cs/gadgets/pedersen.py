# Copy of masp_tpu/r1cs/gadgets/pedersen.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""In-circuit Pedersen hash (masp_proofs/src/circuit/pedersen_hash.rs).

Segmented 3-bit-chunk lookups with conditional negation accumulated in
Montgomery form (3 constraints/add), converted per segment to Edwards (2)
and summed (6).
"""

from __future__ import annotations

from masp_tpu_torch.host.circuits.constants import PEDERSEN_CIRCUIT_GENERATORS
from masp_tpu_torch.host.primitives.pedersen import Personalization
from masp_tpu_torch.host.r1cs.gadgets.boolean import Boolean
from masp_tpu_torch.host.r1cs.gadgets.ecc import EdwardsPoint, MontgomeryPoint
from masp_tpu_torch.host.r1cs.gadgets.lookup import lookup3_xy_with_conditional_negation


def pedersen_hash(cs, personalization: Personalization, bits: list[Boolean]) -> EdwardsPoint:
    personalization_bits = [Boolean.constant(b) for b in personalization.get_bits()]
    assert len(personalization_bits) == 6

    edwards_result = None
    stream = personalization_bits + list(bits)
    pos = 0
    segment_generators = PEDERSEN_CIRCUIT_GENERATORS()
    boolean_false = Boolean.constant(False)

    segment_i = 0
    while pos < len(stream):
        segment_result = None
        segment_windows = segment_generators[segment_i]
        window_i = 0
        w = 0
        while pos < len(stream):
            a = stream[pos]
            b = stream[pos + 1] if pos + 1 < len(stream) else boolean_false
            c = stream[pos + 2] if pos + 2 < len(stream) else boolean_false
            pos += 3

            with cs.ns(f"segment {segment_i}, window {window_i}"):
                tmp_x, tmp_y = lookup3_xy_with_conditional_negation(
                    cs, [a, b, c], segment_windows[w]
                )
            tmp = MontgomeryPoint.interpret_unchecked(tmp_x, tmp_y)

            if segment_result is None:
                segment_result = tmp
            else:
                with cs.ns(f"addition of segment {segment_i}, window {window_i}"):
                    segment_result = tmp.add(cs, segment_result)

            w += 1
            if w == len(segment_windows):
                break
            window_i += 1

        assert segment_result is not None
        with cs.ns(f"conversion of segment {segment_i} into edwards"):
            segment_edwards = segment_result.into_edwards(cs)

        if edwards_result is None:
            edwards_result = segment_edwards
        else:
            with cs.ns(f"addition of segment {segment_i} to accumulator"):
                edwards_result = segment_edwards.add(cs, edwards_result)

        segment_i += 1

    assert edwards_result is not None
    return edwards_result


__all__ = ["pedersen_hash"]
