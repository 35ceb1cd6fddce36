"""PLY point-cloud IO (host-side numpy; feeds device arrays).

Replaces the reference's Open3D ``ReadPointCloud`` / ``WritePointCloud``
(ref:cpp:350-376, examples throughout).  Handles the formats actually used
by the reference data:

  * ``binary_little_endian`` doubles (generated problems,
    ``created_example_reg_problem/source.ply``),
  * ``binary_little_endian`` floats with trailing face elements
    (``stanford_bunny.ply``),
  * ``ascii`` as a convenience.

Pure numpy; the reader stops after the vertex element.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class _Property:
    name: str
    dtype: str  # numpy dtype code without byte order
    is_list: bool = False
    count_dtype: str = ""


@dataclass
class _Element:
    name: str
    count: int
    properties: list = field(default_factory=list)

    @property
    def has_list(self) -> bool:
        return any(p.is_list for p in self.properties)


@dataclass
class PointCloud:
    """A host-side point cloud: points [N,3] float64 + optional normals."""

    points: np.ndarray
    normals: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.points.shape[0])


def _parse_header(f):
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        kw = tokens[0]
        if kw == "comment" or kw == "obj_info":
            continue
        if kw == "format":
            fmt = tokens[1]
        elif kw == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif kw == "property":
            if tokens[1] == "list":
                prop = _Property(tokens[4], _PLY_TYPES[tokens[3]], True,
                                 _PLY_TYPES[tokens[2]])
            else:
                prop = _Property(tokens[2], _PLY_TYPES[tokens[1]])
            elements[-1].properties.append(prop)
        elif kw == "end_header":
            break
        else:
            raise ValueError(f"unknown PLY header keyword: {kw}")
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return fmt, elements


def _element_dtype(elem: _Element, byteorder: str) -> np.dtype:
    return np.dtype([(p.name, byteorder + p.dtype) for p in elem.properties])


def _read_binary_element(f, elem: _Element, byteorder: str,
                         parse: bool) -> np.ndarray | None:
    """Read (or skip) one element's binary payload."""
    if not elem.has_list:
        dt = _element_dtype(elem, byteorder)
        if parse:
            data = np.fromfile(f, dtype=dt, count=elem.count)
            if data.shape[0] != elem.count:
                raise ValueError("truncated PLY payload")
            return data
        f.seek(elem.count * dt.itemsize, os.SEEK_CUR)
        return None
    # Variable-stride element (e.g. bunny faces): walk row by row.
    rows = [] if parse else None
    for _ in range(elem.count):
        row = {}
        for p in elem.properties:
            if p.is_list:
                cnt_dt = np.dtype(byteorder + p.count_dtype)
                n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                item_dt = np.dtype(byteorder + p.dtype)
                payload = f.read(n * item_dt.itemsize)
                if parse:
                    row[p.name] = np.frombuffer(payload, item_dt)
            else:
                dt = np.dtype(byteorder + p.dtype)
                val = np.frombuffer(f.read(dt.itemsize), dt)[0]
                if parse:
                    row[p.name] = val
        if parse:
            rows.append(row)
    return rows


def _read_ascii_element(f, elem: _Element, parse: bool):
    rows = [] if parse else None
    for _ in range(elem.count):
        tokens = f.readline().split()
        if parse and not elem.has_list:
            rows.append([float(t) for t in tokens[: len(elem.properties)]])
    if parse and not elem.has_list:
        arr = np.asarray(rows, dtype=np.float64)
        dt = np.dtype([(p.name, "f8") for p in elem.properties])
        out = np.empty(elem.count, dtype=dt)
        for i, p in enumerate(elem.properties):
            out[p.name] = arr[:, i]
        return out
    return rows


def read_ply(path: str | os.PathLike) -> PointCloud:
    """Read a PLY file's vertex element into a PointCloud (float64)."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        byteorder = {"binary_little_endian": "<",
                     "binary_big_endian": ">",
                     "ascii": "="}[fmt]
        vertex_data = None
        for elem in elements:
            want = elem.name == "vertex"
            if fmt == "ascii":
                data = _read_ascii_element(f, elem, want)
            else:
                data = _read_binary_element(f, elem, byteorder, want)
            if want:
                vertex_data = data
                break  # nothing after the vertex element is needed
    if vertex_data is None:
        raise ValueError(f"{path}: no vertex element")
    names = vertex_data.dtype.names
    pts = np.stack([vertex_data["x"], vertex_data["y"], vertex_data["z"]],
                   axis=1).astype(np.float64)
    normals = None
    if names and all(n in names for n in ("nx", "ny", "nz")):
        normals = np.stack([vertex_data["nx"], vertex_data["ny"],
                            vertex_data["nz"]], axis=1).astype(np.float64)
    return PointCloud(points=pts, normals=normals)


def write_ply(path: str | os.PathLike, cloud: PointCloud | np.ndarray,
              dtype: str = "double") -> None:
    """Write points (and normals if present) as binary little-endian PLY.

    Mirrors Open3D's writer layout for generated problems
    (``created_example_reg_problem/*.ply``: binary LE doubles).
    """
    if isinstance(cloud, np.ndarray):
        cloud = PointCloud(points=np.asarray(cloud))
    pts = np.asarray(cloud.points)
    n = pts.shape[0]
    tname = {"double": "double", "float": "float"}[dtype]
    code = {"double": "<f8", "float": "<f4"}[dtype]
    props = ["x", "y", "z"]
    arrays = [pts[:, 0], pts[:, 1], pts[:, 2]]
    if cloud.normals is not None:
        props += ["nx", "ny", "nz"]
        nrm = np.asarray(cloud.normals)
        arrays += [nrm[:, 0], nrm[:, 1], nrm[:, 2]]
    header = ["ply", "format binary_little_endian 1.0",
              "comment Created by se3-icp-tpu",
              f"element vertex {n}"]
    header += [f"property {tname} {p}" for p in props]
    header += ["end_header"]
    rec = np.empty(n, dtype=np.dtype([(p, code) for p in props]))
    for p, a in zip(props, arrays):
        rec[p] = a
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def read_transform_txt(path: str | os.PathLike) -> np.ndarray:
    """Read a whitespace 4x4 (or 3x4) transform text file.

    Mirrors ``readMatrixFromFile`` (examples/benchmark_extreme_noise_bunny
    .cpp:246-266) and the golden ``transformation_gt.txt`` format.
    """
    vals = np.loadtxt(path, dtype=np.float64)
    vals = np.atleast_2d(vals)
    T = np.eye(4, dtype=np.float64)
    T[: vals.shape[0] if vals.shape[0] < 4 else 4, :4] = vals[:4, :4]
    if vals.shape[0] == 3:
        T[3] = (0.0, 0.0, 0.0, 1.0)
    return T


def read_trajectory_12col(path: str | os.PathLike) -> np.ndarray:
    """Read rows of 12 numbers into [N,4,4] matrices (ref:cc:145-175).

    This is also the KITTI pose format (examples/benchmark_kitti.cpp:79-98).
    """
    rows = np.loadtxt(path, dtype=np.float64)
    rows = np.atleast_2d(rows)[:, :12]
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = rows.reshape(n, 3, 4)
    return out


def write_trajectory_12col(path: str | os.PathLike, mats: np.ndarray) -> None:
    mats = np.asarray(mats, dtype=np.float64)
    np.savetxt(path, mats[:, :3, :4].reshape(mats.shape[0], 12), fmt="%.10g")


def read_velodyne_bin(path: str | os.PathLike) -> np.ndarray:
    """Read a raw KITTI velodyne scan: little-endian float32 rows of
    (x, y, z, reflectance); returns [N,3] float64 points (reflectance
    dropped).  The on-disk format of the official odometry bundle's
    ``sequences/NN/velodyne/%06d.bin`` files, from which the reference's
    Downsampled-PLY bundle was derived (examples/benchmark_kitti.cpp:
    101-107)."""
    raw = np.fromfile(os.fspath(path), dtype="<f4")
    if raw.size % 4:
        raise ValueError(f"{path}: velodyne .bin length {raw.size} is "
                         "not a multiple of 4 floats")
    return raw.reshape(-1, 4)[:, :3].astype(np.float64)


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Open3D ``VoxelDownSample`` semantics: bucket points into a
    ``voxel``-sized grid anchored at the cloud minimum and return one
    CENTROID per occupied voxel.  Brings raw velodyne scans (~120k
    points) to the reference bundle's downsampled density."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if voxel <= 0 or len(pts) == 0:
        return pts
    keys = np.floor((pts - pts.min(axis=0)) / voxel).astype(np.int64)
    if keys.max(initial=0) >= 2 ** 21:
        # 21 bits an axis in the packed key: more bins would alias
        # distinct voxels (a voxel this small for sensor data is a
        # mis-scaled argument)
        raise ValueError(
            f"voxel {voxel} too small for cloud extent: "
            f"{keys.max()} bins on one axis (max {2 ** 21 - 1})")
    kid = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    order = np.argsort(kid, kind="stable")
    kid_s = kid[order]
    start = np.flatnonzero(np.r_[True, kid_s[1:] != kid_s[:-1]])
    sums = np.add.reduceat(pts[order], start, axis=0)
    counts = np.diff(np.r_[start, len(kid_s)])[:, None]
    return sums / counts


def read_redwood_log(path: str | os.PathLike):
    """Read a redwood-format trajectory ``.log`` file.

    Returns (ids [N,3] int, transforms [N,4,4]).  Mirrors
    ``RGBDTrajectory::LoadFromFile`` (examples/benchmark_lounge.cpp:103-127).
    """
    ids, mats = [], []
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    i = 0
    while i + 4 < len(lines) + 1 and i < len(lines):
        head = lines[i].split()
        ids.append([int(head[0]), int(head[1]), int(head[2])])
        rows = [list(map(float, lines[i + r + 1].split()[:4]))
                for r in range(4)]
        mats.append(rows)
        i += 5
    return (np.asarray(ids, dtype=np.int64),
            np.asarray(mats, dtype=np.float64))


def write_redwood_log(path: str | os.PathLike, ids: np.ndarray,
                      mats: np.ndarray) -> None:
    """Mirrors ``RGBDTrajectory::SaveToFile``
    (benchmark_lounge.cpp:128-139)."""
    with open(path, "w") as f:
        for (a, b, c), T in zip(np.asarray(ids), np.asarray(mats)):
            f.write(f"{a}\t{b}\t{c}\n")
            for r in range(4):
                f.write(" ".join(f"{T[r, k]:.8f}" for k in range(4)) + "\n")
