# Copy of masp_tpu/r1cs/gadgets/blake2s.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""In-circuit BLAKE2s with 8-byte personalization (bellman gadgets::blake2s).

Used for ivk derivation, nullifier PRF and the Output circuit's asset
generator integrity check (~21k constraints per invocation).
"""

from __future__ import annotations

from masp_tpu_torch.host.r1cs.cs import MultiEq
from masp_tpu_torch.host.r1cs.gadgets.boolean import Boolean
from masp_tpu_torch.host.r1cs.gadgets.uint32 import UInt32

R1, R2, R3, R4 = 16, 12, 8, 7

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


def _mixing_g(meq: MultiEq, v: list[UInt32], a: int, b: int, c: int, d: int, x: UInt32, y: UInt32):
    cs = meq
    with cs.ns("mixing step 1"):
        v[a] = UInt32.addmany(meq, [v[a], v[b], x])
    with cs.ns("mixing step 2"):
        v[d] = v[d].xor(cs, v[a]).rotr(R1)
    with cs.ns("mixing step 3"):
        v[c] = UInt32.addmany(meq, [v[c], v[d]])
    with cs.ns("mixing step 4"):
        v[b] = v[b].xor(cs, v[c]).rotr(R2)
    with cs.ns("mixing step 5"):
        v[a] = UInt32.addmany(meq, [v[a], v[b], y])
    with cs.ns("mixing step 6"):
        v[d] = v[d].xor(cs, v[a]).rotr(R3)
    with cs.ns("mixing step 7"):
        v[c] = UInt32.addmany(meq, [v[c], v[d]])
    with cs.ns("mixing step 8"):
        v[b] = v[b].xor(cs, v[c]).rotr(R4)


def _compression(cs, h: list[UInt32], m: list[UInt32], t: int, f: bool):
    assert len(h) == 8 and len(m) == 16
    v = list(h)
    v.append(UInt32.constant(IV[0]))
    v.append(UInt32.constant(IV[1]))
    v.append(UInt32.constant(IV[2]))
    v.append(UInt32.constant(IV[3]))
    v.append(UInt32.constant(IV[4] ^ (t & 0xFFFFFFFF)))
    v.append(UInt32.constant(IV[5] ^ (t >> 32)))
    v.append(UInt32.constant(IV[6] ^ 0xFFFFFFFF if f else IV[6]))
    v.append(UInt32.constant(IV[7]))

    with MultiEq(cs) as meq:
        for i in range(10):
            with cs.ns(f"round {i}"):
                s = SIGMA[i % 10]
                with cs.ns("mixing g1"):
                    _mixing_g(meq, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
                with cs.ns("mixing g2"):
                    _mixing_g(meq, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
                with cs.ns("mixing g3"):
                    _mixing_g(meq, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
                with cs.ns("mixing g4"):
                    _mixing_g(meq, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
                with cs.ns("mixing g5"):
                    _mixing_g(meq, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
                with cs.ns("mixing g6"):
                    _mixing_g(meq, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
                with cs.ns("mixing g7"):
                    _mixing_g(meq, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
                with cs.ns("mixing g8"):
                    _mixing_g(meq, v, 3, 4, 9, 14, m[s[14]], m[s[15]])

    for i in range(8):
        with cs.ns(f"h {i}"):
            with cs.ns("first xor"):
                h[i] = h[i].xor(cs, v[i])
            with cs.ns("second xor"):
                h[i] = h[i].xor(cs, v[i + 8])


def blake2s(cs, input_bits: list[Boolean], personalization: bytes) -> list[Boolean]:
    assert len(personalization) == 8
    assert len(input_bits) % 8 == 0

    h = [
        UInt32.constant(IV[0] ^ 0x01010000 ^ 32),
        UInt32.constant(IV[1]),
        UInt32.constant(IV[2]),
        UInt32.constant(IV[3]),
        UInt32.constant(IV[4]),
        UInt32.constant(IV[5]),
        UInt32.constant(IV[6] ^ int.from_bytes(personalization[0:4], "little")),
        UInt32.constant(IV[7] ^ int.from_bytes(personalization[4:8], "little")),
    ]

    blocks: list[list[UInt32]] = []
    for off in range(0, len(input_bits), 512):
        block = input_bits[off : off + 512]
        this_block = []
        for woff in range(0, len(block), 32):
            word = block[woff : woff + 32]
            word = word + [Boolean.constant(False)] * (32 - len(word))
            this_block.append(UInt32.from_bits(word))
        while len(this_block) < 16:
            this_block.append(UInt32.constant(0))
        blocks.append(this_block)
    if not blocks:
        blocks.append([UInt32.constant(0) for _ in range(16)])

    for i, block in enumerate(blocks[:-1]):
        with cs.ns(f"block {i}"):
            _compression(cs, h, block, (i + 1) * 64, False)
    with cs.ns(f"block {len(blocks) - 1}"):
        _compression(cs, h, blocks[-1], len(input_bits) // 8, True)

    out: list[Boolean] = []
    for word in h:
        out.extend(word.into_bits())
    return out


__all__ = ["blake2s"]
