"""Reference-grade aligners over general cost models (re-design of the
`pa-base-algos` crate): band-doubling affine NW and diagonal-transition
(WFA/BiWFA).  Not on the device product path (SURVEY.md §1 L4); used for
cost-model generality and differential testing."""

from .dt import DiagonalTransition
from .nw_affine import NwAffine

__all__ = ["NwAffine", "DiagonalTransition"]
