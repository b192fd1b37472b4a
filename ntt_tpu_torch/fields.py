"""Prime-field specifications for the PyTorch/CUDA port.

A copy of ``ntt_tpu.fields`` (that package imports JAX on import, the port
must not): the same :class:`Field` with every derived Montgomery constant and
the same four instances, plus ``np0_32`` — the word-level quotient constant
the CUDA kernels use for their 32-bit Montgomery steps.

All members are plain Python ints; no device work happens here.
"""

from __future__ import annotations

import dataclasses
import functools

HALF_BITS = 16
HALF_MASK = (1 << HALF_BITS) - 1
WORD_BITS = 32


def pow_mod(base: int, exp: int, p: int) -> int:
    """Host-exact modular exponentiation."""
    return pow(base % p, exp, p)


def inv_mod(x: int, p: int) -> int:
    """Modular inverse via Fermat."""
    return pow(x % p, p - 2, p)


def _inv_2adic(x: int, bits: int) -> int:
    """Inverse of odd x modulo 2^bits by Newton iteration."""
    assert x & 1
    inv = 1
    for _ in range(bits.bit_length() + 1):
        inv = (inv * (2 - x * inv)) % (1 << bits)
    return inv % (1 << bits)


@dataclasses.dataclass(frozen=True)
class Field:
    """A prime field with a 2^two_adicity root of unity, plus derived
    Montgomery constants for the 16-bit-half-limb representation."""

    name: str
    p: int
    generator: int
    two_adicity: int

    # ---- derived ----------------------------------------------------------
    @functools.cached_property
    def bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def n_words(self) -> int:
        """Number of 32-bit words per element."""
        return (self.bits + WORD_BITS - 1) // WORD_BITS

    @functools.cached_property
    def n_halves(self) -> int:
        """Number of 16-bit half-limbs per element."""
        return 2 * self.n_words

    @functools.cached_property
    def mont_bits(self) -> int:
        return HALF_BITS * self.n_halves

    @functools.cached_property
    def R(self) -> int:
        """Montgomery radix R = 2^(16 * n_halves) mod p."""
        return (1 << self.mont_bits) % self.p

    @functools.cached_property
    def R2(self) -> int:
        """R^2 mod p — multiplier for to-Montgomery conversion."""
        return (self.R * self.R) % self.p

    @functools.cached_property
    def R_inv(self) -> int:
        return inv_mod(1 << self.mont_bits, self.p)

    @functools.cached_property
    def np0(self) -> int:
        """-p^{-1} mod 2^16 (CIOS per-iteration quotient constant)."""
        return (-_inv_2adic(self.p, HALF_BITS)) & HALF_MASK

    @functools.cached_property
    def np0_32(self) -> int:
        """-p^{-1} mod 2^32 (quotient constant of the kernels' word-level
        Montgomery steps)."""
        return (-_inv_2adic(self.p, WORD_BITS)) & 0xFFFFFFFF

    @functools.cached_property
    def p_halves(self) -> tuple:
        return tuple(self.int_to_halves(self.p))

    # ---- conversions -------------------------------------------------------
    def int_to_halves(self, x: int) -> list:
        return [(x >> (HALF_BITS * i)) & HALF_MASK for i in range(self.n_halves)]

    def int_to_words(self, x: int) -> list:
        return [(x >> (WORD_BITS * i)) & 0xFFFFFFFF for i in range(self.n_words)]

    def words_to_int(self, words) -> int:
        return sum(int(w) << (WORD_BITS * i) for i, w in enumerate(words))

    def to_mont_int(self, x: int) -> int:
        return (x * (1 << self.mont_bits)) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.R_inv) % self.p

    # ---- roots of unity ----------------------------------------------------
    def root_of_unity(self, n: int) -> int:
        """Primitive n-th root of unity ω_n = g^((p-1)/n)."""
        assert n & (n - 1) == 0, "n must be a power of two"
        assert n.bit_length() - 1 <= self.two_adicity, (
            f"{self.name}: n=2^{n.bit_length()-1} exceeds two-adicity "
            f"{self.two_adicity}"
        )
        return pow_mod(self.generator, (self.p - 1) // n, self.p)

    def inv_root_of_unity(self, n: int) -> int:
        return inv_mod(self.root_of_unity(n), self.p)

    def validate(self) -> None:
        """Value checks of the field's defining constants."""
        assert self.p & 1, f"{self.name}: modulus must be odd for Montgomery"
        assert self.p > 3
        assert (self.p - 1) % (1 << self.two_adicity) == 0
        w = self.root_of_unity(1 << self.two_adicity)
        assert pow_mod(w, 1 << self.two_adicity, self.p) == 1
        assert pow_mod(w, 1 << (self.two_adicity - 1), self.p) == self.p - 1


# ---------------------------------------------------------------------------
# Field instances (the same four as ntt_tpu.fields)
# ---------------------------------------------------------------------------

#: The small Proth prime P = 7*2^26 + 1 with generator 3.
SMALL = Field(name="small-proth", p=469762049, generator=3, two_adicity=26)

#: BN254 (alt_bn128) scalar field Fr.
BN254_FR = Field(
    name="bn254-fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    two_adicity=28,
)

#: BLS12-381 scalar field Fr.
BLS12_381_FR = Field(
    name="bls12-381-fr",
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    two_adicity=32,
)

#: Goldilocks prime 2^64 - 2^32 + 1.
GOLDILOCKS = Field(
    name="goldilocks",
    p=(1 << 64) - (1 << 32) + 1,
    generator=7,
    two_adicity=32,
)

FIELDS = {f.name: f for f in (SMALL, BN254_FR, BLS12_381_FR, GOLDILOCKS)}


def get_field(name: str) -> Field:
    try:
        return FIELDS[name]
    except KeyError:
        raise ValueError(
            f"unknown field {name!r}; available: {sorted(FIELDS)}") from None
