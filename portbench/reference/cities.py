"""The cities templates (q2-q5 on one card, m1-m7 over the mesh) in plain
PyTorch over the generated table, with every float computation in `F`."""

from __future__ import annotations

from portbench.core.tables import Tables
from portbench.reference.common import gcount, gext, groups, gsum, host, order


def _cols(t: Tables, F):
    c = t["cities"]
    return c["k"].data, c["d"].data, c["lat"].data.to(F), c["lng"].data.to(F), c["g"].data


def m1(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    m = lat > 57.9
    return [host(k[m], "i32"), host(lat[m], "f64"), host(lng[m], "f64"), host(lat[m] + lng[m], "f64")]


def q2(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    inv, n, (kk,) = groups(k)
    return [host(kk, "i32"), host(gext(inv, n, lat, "amin"), "f64"), host(gext(inv, n, lat, "amax"), "f64"),
            host(gsum(inv, n, lng), "f64"), host(gcount(inv, n), "u64")]


def q3(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    inv, n, (kd,) = groups(d)
    cnt = gcount(inv, n)
    s = slice(0, 10)
    return [host(kd[s], "i32"), host(gsum(inv, n, lng)[s], "f64"), host((gsum(inv, n, lat) / cnt)[s], "f64"),
            host(gext(inv, n, lat, "amin")[s], "f64"), host(cnt[s], "u64")]


def q4(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    inv, n, (kg,) = groups(g)
    cnt = gcount(inv, n)
    return [host(kg, "i32"), host(gsum(inv, n, lng), "f64"), host(gsum(inv, n, lat) / cnt, "f64"), host(cnt, "u64")]


def q5(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    m = lat > p["LAT"]
    inv, n, (kg,) = groups(g[m])
    return [host(kg, "i32"), host(gext(inv, n, lat[m], "amin"), "f64"), host(gext(inv, n, lng[m], "amax"), "f64"),
            host(gcount(inv, n), "u64")]


def m3(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    inv, n, (kg,) = groups(g)
    cnt = gcount(inv, n)
    return [host(kg, "i32"), host(gsum(inv, n, lng), "f64"), host(gsum(inv, n, lat) / cnt, "f64"),
            host(gext(inv, n, lat, "amin"), "f64"), host(gext(inv, n, lng, "amax"), "f64"), host(cnt, "u64")]


def m5(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    inv, n, (kk,) = groups(k)
    return [host(kk, "i32"), host(gsum(inv, n, lng), "f64"), host(gcount(inv, n), "u64")]


def m6(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    o = order((k, False), (d, False), (lat, False))[:10000]
    return [host(k[o], "i32"), host(d[o], "i32"), host(lat[o], "f64")]


def m7(t, p, F):
    k, d, lat, lng, g = _cols(t, F)
    o = order((lat, False))[:5000]
    return [host(lat[o], "f64"), host(g[o], "i32")]
