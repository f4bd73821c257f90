"""Scene DSL parser.

Reimplements the reference's hand-rolled text grammar (src/scene.c:206-609)
as an idiomatic Python scanner that emits `ObjectSpec`s / a `Scene` pytree.

Grammar (see SURVEY.md §3.4):

    scene    := object*
    object   := ("sphere" | "cube") property*
    property := name value
    value    := number | "{" number number number "}"
    number   := "-"? digit+ ("." digit+)?        # no exponents, no leading dot

Reference quirks preserved deliberately:

* After matching the property names ``albedo`` and ``metallic`` the
  reference advances the cursor by 9 and 11 chars respectively instead of
  6 and 8 (src/scene.c:271-280, 309-320), silently consuming up to 3
  following chars. We replicate by consuming the name plus up to 3
  whitespace chars — which accepts every file the reference accepts and
  additionally (unlike the reference) does not mis-parse files with fewer
  than 3 spaces after those names.
* Whitespace = space, CR, tab, LF only (src/utils.h:34).
* Range validation: albedo/emission_color components and roughness/
  reflectance/metallic in [0,1]; cube size >= 0 (src/scene.c:530-599).
* Properties are object-kind checked: radius/center sphere-only,
  origin/size cube-only (src/scene.c:364-410).
* Objects beyond MAX_OBJECTS are dropped with a warning (src/scene.c:602-605).
* Line-numbered error messages.
"""

from __future__ import annotations

import pathlib
import sys

from ray_tracing_tpu.scene.types import ObjectSpec, Scene

MAX_OBJECTS = 1024  # src/scene.h:3

_SPACE = " \r\t\n"

# name -> (is_vector, sphere_only, cube_only, extra_skip)
_PROPERTIES = {
    "albedo": (True, False, False, 3),          # skips 9 chars, src/scene.c:280
    "roughness": (False, False, False, 0),
    "reflectance": (False, False, False, 0),
    "metallic": (False, False, False, 3),       # skips 11 chars, src/scene.c:320
    "emission_power": (False, False, False, 0),
    "emission_color": (True, False, False, 0),
    "radius": (False, True, False, 0),
    "center": (True, True, False, 0),
    "origin": (True, False, True, 0),
    "size": (True, False, True, 0),
}


def _is_digit(c: str) -> bool:
    """ASCII-only digit (src/utils.h:35) — str.isdigit accepts Unicode
    digit-likes the reference rejects (and float() may then raise an
    uncaught ValueError)."""
    return "0" <= c <= "9"


class SceneParseError(ValueError):
    def __init__(self, message: str, line: int):
        super().__init__(f"{message} (line {line})")
        self.line = line


class _Scanner:
    __slots__ = ("src", "i", "line")

    def __init__(self, src: str):
        self.src = src
        self.i = 0
        self.line = 1

    def eof(self) -> bool:
        return self.i >= len(self.src)

    def peek(self) -> str:
        return self.src[self.i] if self.i < len(self.src) else ""

    def skip_spaces(self) -> None:
        src, i, n = self.src, self.i, len(self.src)
        while i < n and src[i] in _SPACE:
            if src[i] == "\n":
                self.line += 1
            i += 1
        self.i = i

    def skip_raw(self, count: int) -> None:
        """Advance exactly `count` chars REGARDLESS of what they are — the
        reference's albedo/metallic cursor quirk (src/scene.c:280, :320
        advance 9/11 = keyword + 3): a value with fewer than 3 spaces after
        those property names loses its leading characters. Found by fuzz
        parity vs the compiled reference ("metallic 1.0000" parses as
        metallic=0 — the C eats "1."); line counting still tracks any
        newlines eaten."""
        src, i, n = self.src, self.i, len(self.src)
        end = min(n, i + count)
        while i < end:
            if src[i] == "\n":
                self.line += 1
            i += 1
        self.i = i

    def match_word(self, word: str) -> bool:
        if self.src.startswith(word, self.i):
            self.i += len(word)
            return True
        return False

    def parse_number(self, what: str) -> float:
        """Reference number grammar: -?digits(.digits)? (src/scene.c:427-461)."""
        src, n = self.src, len(self.src)
        sign = 1.0
        if self.peek() == "-":
            sign = -1.0
            self.i += 1
            if self.eof() or not _is_digit(src[self.i]):
                raise SceneParseError("Error: Missing number after minus sign", self.line)
        elif self.eof() or not _is_digit(src[self.i]):
            raise SceneParseError(f"Error: Missing number {what}", self.line)

        start = self.i
        i = self.i
        while i < n and _is_digit(src[i]):
            i += 1
        if i < n and src[i] == ".":
            i += 1
            if i == n or not _is_digit(src[i]):
                self.i = i
                raise SceneParseError("Error: Missing decimal part after dot", self.line)
            while i < n and _is_digit(src[i]):
                i += 1
        self.i = i
        return sign * float(src[start:i])

    def parse_vector(self) -> tuple:
        if self.peek() != "{":
            raise SceneParseError("Error: Missing '{' after property name", self.line)
        self.i += 1
        vals = []
        for j in range(3):
            self.skip_spaces()
            vals.append(self.parse_number(f"{j} in vector value"))
        self.skip_spaces()
        if self.eof() or self.peek() != "}":
            raise SceneParseError("Error: Missing '}' after property value", self.line)
        self.i += 1
        return tuple(vals)


def _check_unit_range(name: str, v, line: int) -> None:
    vals = v if isinstance(v, tuple) else (v,)
    if any(x < 0 or x > 1 for x in vals):
        raise SceneParseError(f"Error: {name} values must be between 0 and 1", line)


def parse_objects(src: str, warn=None) -> list[ObjectSpec]:
    """Parse the DSL into a list of ObjectSpecs (host side, no JAX)."""
    if warn is None:
        warn = lambda msg: print(msg, file=sys.stderr)

    s = _Scanner(src)
    objects: list[ObjectSpec] = []

    while True:
        s.skip_spaces()
        if s.eof():
            break

        if s.match_word("sphere"):
            obj = ObjectSpec(kind="sphere")
        elif s.match_word("cube"):
            obj = ObjectSpec(
                kind="cube",
                p0=(0.0, 0.0, 0.0),
                p1=(1.0, 1.0, 1.0),
            )
        else:
            raise SceneParseError("Error: Invalid character", s.line)

        # property loop (src/scene.c:261-600)
        while True:
            s.skip_spaces()
            prop = None
            for name, meta in _PROPERTIES.items():
                if s.src.startswith(name, s.i):
                    prop, (is_vec, sphere_only, cube_only, extra) = name, meta
                    s.i += len(name)
                    s.skip_raw(extra)
                    break
            if prop is None:
                break  # not a property name -> next object or EOF

            if sphere_only and obj.kind != "sphere":
                raise SceneParseError(f"Property '{prop}' only allowed on spheres", s.line)
            if cube_only and obj.kind != "cube":
                raise SceneParseError(f"Property '{prop}' only allowed on cubes", s.line)

            s.skip_spaces()
            if s.eof():
                raise SceneParseError("Error: Property value is missing", s.line)

            if is_vec:
                value = s.parse_vector()
            else:
                value = s.parse_number("after property name")

            line = s.line
            if prop == "albedo":
                _check_unit_range("albedo", value, line)
                obj.albedo = value
            elif prop == "roughness":
                _check_unit_range("Roughness", value, line)
                obj.roughness = value
            elif prop == "reflectance":
                _check_unit_range("Reflectance", value, line)
                obj.reflectance = value
            elif prop == "metallic":
                _check_unit_range("Metallic", value, line)
                obj.metallic = value
            elif prop == "emission_power":
                obj.emission_power = value
            elif prop == "emission_color":
                _check_unit_range("Emission color", value, line)
                obj.emission_color = value
            elif prop == "radius":
                obj.p1 = (value, value, value)
            elif prop == "center":
                obj.p0 = value
            elif prop == "origin":
                obj.p0 = value
            elif prop == "size":
                if any(x < 0 for x in value):
                    raise SceneParseError("Error: Size values must be positive", line)
                obj.p1 = value

        if len(objects) >= MAX_OBJECTS:
            warn(f"Warning: Ignoring object because the scene is too big (line {s.line})")
        else:
            objects.append(obj)

    return objects


def parse_scene_string(src: str) -> Scene:
    return Scene.from_objects(parse_objects(src))


def parse_scene_file(path: str) -> Scene:
    with open(path, "r") as f:
        return parse_scene_string(f.read())


# Scene files kept with the repository (scenes/ at the checkout root).
SCENES_DIR = pathlib.Path(__file__).resolve().parents[2] / "scenes"


def scene_file(name: str) -> str:
    """Path of an in-repo scene: "scene_2" (three mirror/metal spheres) or
    "room" (a single-light diffuse room, so NEE and the shadow trace run)."""
    path = SCENES_DIR / f"{name}.txt"
    if not path.exists():
        raise FileNotFoundError(f"no in-repo scene {name!r} ({path})")
    return str(path)
