"""Minimal unit system (astropy.units stand-in).

The reference framework threads astropy Quantities for times and masses
through its public API (e.g. bhnerf/emission.py:179-189,
bhnerf/optimization.py:155-156). Only a handful of conversions are ever
exercised end-to-end (hr/min/s for times; kg for masses; rad/deg for
angles), so this module implements a tiny, dependency-free Quantity that
covers that surface. Quantities carry plain numpy arrays; `.value`
extraction happens before anything enters a jitted function, exactly like
the reference's host/device split.
"""
from __future__ import annotations

import numpy as np

# conversion factor of each unit to its dimension's base unit
_TIME = {'s': 1.0, 'sec': 1.0, 'second': 1.0, 'min': 60.0, 'minute': 60.0,
         'hr': 3600.0, 'hour': 3600.0, 'h': 3600.0, 'day': 86400.0}
_MASS = {'kg': 1.0, 'g': 1e-3}
_LENGTH = {'m': 1.0, 'km': 1e3, 'cm': 1e-2,
           'lyr': 9.4607304725808e15, 'lightyear': 9.4607304725808e15,
           'pc': 3.0856775814913673e16, 'au': 1.495978707e11}
_ANGLE = {'rad': 1.0, 'deg': np.pi / 180.0,
          'arcsec': np.pi / 180.0 / 3600.0,
          'uas': np.pi / 180.0 / 3600.0 / 1e6}
_DIMENSIONLESS = {'': 1.0, 'unitless': 1.0}

_REGISTRY = {}
for _table, _dim in ((_TIME, 'time'), (_MASS, 'mass'), (_LENGTH, 'length'),
                     (_ANGLE, 'angle'), (_DIMENSIONLESS, 'dimensionless')):
    for _name, _factor in _table.items():
        _REGISTRY[_name] = (_dim, _factor)


class Unit:
    """A named unit with a dimension and scale to the base unit."""

    __slots__ = ('name', 'dimension', 'factor')

    def __init__(self, name):
        if isinstance(name, Unit):
            name, dimension, factor = name.name, name.dimension, name.factor
        else:
            if name not in _REGISTRY:
                raise ValueError(f'unknown unit: {name!r}')
            dimension, factor = _REGISTRY[name]
        self.name = name
        self.dimension = dimension
        self.factor = factor

    def __eq__(self, other):
        try:
            other = Unit(other)
        except (ValueError, TypeError):
            return NotImplemented
        return self.name == other.name or (
            self.dimension == other.dimension and self.factor == other.factor)

    def __hash__(self):
        return hash((self.dimension, self.factor))

    def __repr__(self):
        return f'Unit({self.name!r})'

    def __str__(self):
        return self.name

    # mirrors astropy's `value * u.hr` idiom
    def __rmul__(self, value):
        return Quantity(value, self)


class Quantity:
    """value + unit; supports .to(), .value, .unit and basic arithmetic."""

    __slots__ = ('value', 'unit')

    # numpy left operands (np.float64(1.0) - q, ndarray - q) would
    # otherwise resolve through ndarray's ufunc machinery and silently
    # strip the unit; declaring the ufunc protocol unsupported makes
    # numpy return NotImplemented so Python falls back to our reflected
    # operators (and direct ufunc calls fail loudly instead of
    # laundering hours into M units)
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, value, unit):
        if isinstance(value, Quantity):
            value = value.to(unit).value
        self.value = np.asarray(value) if np.ndim(value) else value
        self.unit = Unit(unit)

    def to(self, unit):
        unit = Unit(unit)
        if unit.dimension != self.unit.dimension:
            raise ValueError(
                f'cannot convert {self.unit.name} -> {unit.name}')
        return Quantity(np.asarray(self.value) * (self.unit.factor / unit.factor), unit)

    # ---- arithmetic (only what the training API exercises) -------------
    def __add__(self, other):
        if isinstance(other, Quantity):
            other = other.to(self.unit).value
        return Quantity(np.asarray(self.value) + other, self.unit)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, Quantity):
            other = other.to(self.unit).value
        return Quantity(np.asarray(self.value) - other, self.unit)

    def __rsub__(self, other):
        if isinstance(other, Quantity):
            other = other.to(self.unit).value
        return Quantity(other - np.asarray(self.value), self.unit)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            raise TypeError('Quantity*Quantity not supported in this subset')
        return Quantity(np.asarray(self.value) * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return np.asarray(self.to(other.unit).value) / np.asarray(other.value)
        return Quantity(np.asarray(self.value) / other, self.unit)

    def __neg__(self):
        return Quantity(-np.asarray(self.value), self.unit)

    def __getitem__(self, key):
        return Quantity(np.asarray(self.value)[key], self.unit)

    def __len__(self):
        return len(np.asarray(self.value))

    def __iter__(self):
        for v in np.atleast_1d(self.value):
            yield Quantity(v, self.unit)

    def __array__(self, dtype=None):
        return np.asarray(self.value, dtype=dtype)

    def __repr__(self):
        return f'Quantity({self.value!r}, {self.unit.name!r})'

    def __eq__(self, other):
        if isinstance(other, Quantity):
            return np.all(np.asarray(self.value) ==
                          np.asarray(other.to(self.unit).value))
        return NotImplemented

    @property
    def shape(self):
        return np.shape(self.value)

    @property
    def ndim(self):
        return np.ndim(self.value)

    @property
    def size(self):
        return np.size(self.value)


# unit singletons mirroring `astropy.units` attribute access
hr = Unit('hr')
hour = Unit('hour')
min = Unit('min')  # noqa: A001 - mirrors astropy namespace
s = Unit('s')
sec = Unit('sec')
day = Unit('day')
kg = Unit('kg')
g = Unit('g')
m = Unit('m')
km = Unit('km')
lyr = Unit('lyr')
lightyear = Unit('lightyear')
pc = Unit('pc')
rad = Unit('rad')
deg = Unit('deg')
uas = Unit('uas')


def strip_time(value, default_unit=hr):
    """Return (plain float/array, Unit) from value that may be a Quantity."""
    if isinstance(value, Quantity):
        return np.asarray(value.value), value.unit
    return np.asarray(value), Unit(default_unit)
