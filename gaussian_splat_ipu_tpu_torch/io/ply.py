"""PLY and XYZ point-cloud reading and PLY writing with numpy alone: the
port's own copy of the reference's parser (gaussian_splat_ipu_tpu/io/
ply.py), whose float columns are stacked by the native host library when it
is built (io/native.py) and by numpy otherwise. `.splat` files are read by
io/splat.py. A row range of the vertices can be read alone (sharded
loading, parallel/multihost.py): a binary vertex table of scalars is read
with seeks, other layouts are parsed whole and sliced.

Binary (little and big endian) and ascii PLY parse into one structured
numpy array per element; elements with list properties (a mesh's faces)
take a row-by-row path so that the stream advances past them. Field set:
x/y/z, f_dc_0..2, opacity, scale_0..2, rot_0..3 and f_rest_* when present
(the reference loader, src/splat/file_io.cpp:62-77)."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from gaussian_splat_ipu_tpu_torch.io import native

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PlyElement:
    name: str
    count: int
    properties: List[Tuple[str, str]]  # (name, numpy dtype code)
    data: Optional[np.ndarray] = None  # structured array (scalar props)
    # (name, count dtype code, value dtype code) of each list property.
    list_properties: List[Tuple[str, str, str]] = dataclasses.field(
        default_factory=list)
    lists: Dict[str, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)
    # Declaration order: ("scalar", name, code) or ("list", name,
    # count_code, value_code); a row's values interleave in this order.
    order: List[Tuple] = dataclasses.field(default_factory=list)

    def column(self, name: str) -> np.ndarray:
        return np.asarray(self.data[name])


@dataclasses.dataclass
class PlyData:
    """Parsed PLY file: elements by name."""

    elements: Dict[str, PlyElement]
    fmt: str

    def __getitem__(self, name: str) -> PlyElement:
        return self.elements[name]


def _parse_header(stream) -> Tuple[List[PlyElement], str]:
    if stream.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PlyElement] = []
    while True:
        line = stream.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                codes = (_PLY_TO_NUMPY[tokens[2]], _PLY_TO_NUMPY[tokens[3]])
                elements[-1].list_properties.append((tokens[4], *codes))
                elements[-1].order.append(("list", tokens[4], *codes))
            else:
                code = _PLY_TO_NUMPY[tokens[1]]
                elements[-1].properties.append((tokens[2], code))
                elements[-1].order.append(("scalar", tokens[2], code))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing format line")
    return elements, fmt


def _scalar_record(el: PlyElement, scalars) -> None:
    if el.properties:
        rec = np.empty(el.count, np.dtype(el.properties))
        for n, _ in el.properties:
            rec[n] = scalars[n]
        el.data = rec


def _read_list_element_ascii(el: PlyElement, rows, pos: int) -> int:
    """Token-walk one element whose rows contain list properties."""
    scalars = {n: np.empty(el.count, np.dtype(c))
               for n, c in el.properties}
    lists = {n: [] for n, _, _ in el.list_properties}
    for r in range(el.count):
        for kind in el.order:
            if kind[0] == "scalar":
                scalars[kind[1]][r] = np.dtype(kind[2]).type(rows[pos])
                pos += 1
            else:
                cnt = int(rows[pos])
                pos += 1
                lists[kind[1]].append(
                    np.array(rows[pos:pos + cnt], np.dtype(kind[3])))
                pos += cnt
    _scalar_record(el, scalars)
    el.lists = lists
    return pos


def _read_list_element_binary(el: PlyElement, f, endian: str) -> None:
    """Row-by-row binary parse of an element with list properties."""
    scalars = {n: np.empty(el.count, np.dtype(c))
               for n, c in el.properties}
    lists = {n: [] for n, _, _ in el.list_properties}
    for r in range(el.count):
        for kind in el.order:
            if kind[0] == "scalar":
                dt = np.dtype(endian + kind[2])
                scalars[kind[1]][r] = np.frombuffer(
                    f.read(dt.itemsize), dt)[0]
            else:
                cdt = np.dtype(endian + kind[2])
                vdt = np.dtype(endian + kind[3])
                cnt = int(np.frombuffer(f.read(cdt.itemsize), cdt)[0])
                lists[kind[1]].append(
                    np.frombuffer(f.read(vdt.itemsize * cnt), vdt,
                                  count=cnt))
    _scalar_record(el, scalars)
    el.lists = lists


def count_vertices(path: str) -> int:
    """The vertex count from the header alone."""
    with open(path, "rb") as f:
        elements, _ = _parse_header(f)
    for el in elements:
        if el.name == "vertex":
            return el.count
    raise ValueError("PLY has no vertex element")


def _vertex_rows(el: PlyElement, vertex_range) -> None:
    """Cut a parsed vertex element to rows [lo, hi)."""
    lo, hi = vertex_range
    if el.data is not None:
        el.data = el.data[lo:hi]
    el.lists = {k: v[lo:hi] for k, v in el.lists.items()}
    el.count = hi - lo


def read_ply(path: str, vertex_range: Optional[Tuple[int, int]] = None
             ) -> PlyData:
    """Parse a PLY file into structured numpy arrays, one per element;
    with vertex_range=(lo, hi), only those rows of the vertex element."""
    if vertex_range is not None and not 0 <= vertex_range[0] \
            <= vertex_range[1]:
        raise ValueError(f"bad vertex_range {vertex_range}")
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        if fmt == "ascii":
            rows = f.read().decode("ascii").split()
            pos = 0
            for el in elements:
                if el.list_properties:
                    pos = _read_list_element_ascii(el, rows, pos)
                    continue
                width = len(el.properties)
                table = np.array(rows[pos:pos + el.count * width]).reshape(
                    el.count, width)
                pos += el.count * width
                rec = np.empty(el.count, np.dtype(el.properties))
                for i, (n, c) in enumerate(el.properties):
                    rec[n] = table[:, i].astype(np.dtype(c))
                el.data = rec
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            for el in elements:
                if el.list_properties:
                    _read_list_element_binary(el, f, endian)
                    continue
                dt = np.dtype([(n, endian + c) for n, c in el.properties])
                if el.name == "vertex" and vertex_range is not None:
                    lo, hi = vertex_range
                    f.seek(lo * dt.itemsize, 1)
                    el.data = np.frombuffer(f.read(dt.itemsize * (hi - lo)),
                                            dt, count=hi - lo)
                    f.seek((el.count - hi) * dt.itemsize, 1)
                    el.count = hi - lo
                    continue
                buf = f.read(dt.itemsize * el.count)
                el.data = np.frombuffer(buf, dt, count=el.count)
    if vertex_range is not None and "vertex" in {e.name for e in elements}:
        vertex = next(e for e in elements if e.name == "vertex")
        if vertex.count != vertex_range[1] - vertex_range[0]:
            _vertex_rows(vertex, vertex_range)
    return PlyData({el.name: el for el in elements}, fmt)


def ply_header(names, count: int, element: str = "vertex") -> bytes:
    """binary_little_endian header for float32 columns."""
    header = ["ply", "format binary_little_endian 1.0",
              f"element {element} {count}"]
    header += [f"property float {n}" for n in names]
    header.append("end_header\n")
    return "\n".join(header).encode("ascii")


def pack_records(columns: Dict[str, np.ndarray]) -> np.ndarray:
    """Interleave float32 columns into the PLY record array."""
    names = list(columns)
    count = len(next(iter(columns.values())))
    rec = np.empty(count, np.dtype([(n, "<f4") for n in names]))
    for n in names:
        rec[n] = np.asarray(columns[n], np.float32)
    return rec


def write_ply(path: str, columns: Dict[str, np.ndarray],
              element: str = "vertex") -> None:
    """Write float32 columns as a binary_little_endian PLY."""
    rec = pack_records(columns)
    with open(path, "wb") as f:
        f.write(ply_header(list(columns), len(rec), element))
        f.write(rec.tobytes())


_F_REST_RE = re.compile(r"^f_rest_(\d+)$")


def gaussian_fields_from_ply(ply: PlyData):
    """The 3DGS field set of a parsed PLY: a dict of means (N, 3) and, when
    present, f_dc (N, 3), opacity (N,), log_scales (N, 3), quats (N, 4)
    and f_rest (N, M, 3) (3DGS stores f_rest channel-major)."""
    v = ply["vertex"]
    cols = {n for n, _ in v.properties}

    def stack(names):
        fast = native.stack_f32_columns(v.data, names)
        if fast is not None:
            return fast
        return np.stack([v.column(n).astype(np.float32) for n in names], -1)

    out = {"means": stack(["x", "y", "z"])}
    if "f_dc_0" in cols:
        out["f_dc"] = stack(["f_dc_0", "f_dc_1", "f_dc_2"])
        out["opacity"] = v.column("opacity").astype(np.float32)
        out["log_scales"] = stack(["scale_0", "scale_1", "scale_2"])
        out["quats"] = stack(["rot_0", "rot_1", "rot_2", "rot_3"])
    rest = sorted((int(_F_REST_RE.match(n).group(1)), n)
                  for n in cols if _F_REST_RE.match(n))
    if rest:
        flat = stack([n for _, n in rest])
        m = flat.shape[1] // 3
        out["f_rest"] = flat.reshape(-1, 3, m).transpose(0, 2, 1)
    return out


def read_xyz(path: str, row_range=None) -> np.ndarray:
    """Load a whitespace-separated xyz text point cloud -> (N, 3) f32
    (the reference loadXyz, src/splat/file_io.cpp:11-28); row_range=(lo,
    hi) keeps those rows."""
    pts = np.loadtxt(path, dtype=np.float32, usecols=(0, 1, 2),
                     ndmin=2).astype(np.float32)
    return pts if row_range is None else pts[row_range[0]:row_range[1]]


def load_points(path: str, row_range=None):
    """The field dict of a .ply, .xyz or .splat file, by extension;
    row_range=(lo, hi) reads only those rows (sharded loading)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "xyz":
        return {"means": read_xyz(path, row_range)}
    if ext == "ply":
        return gaussian_fields_from_ply(read_ply(path, row_range))
    if ext == "splat":
        from gaussian_splat_ipu_tpu_torch.io import splat as splat_io
        return splat_io.read_splat(path, row_range)
    raise ValueError(f"unsupported scene file extension: .{ext} (the port "
                     "reads .ply, .xyz and .splat)")
