"""Constants: film frame formats, RAW extensions, color matrices, EXIF keys.

Same capability surface as reference src/raw2film/data.py (film formats,
RAW extension list, Rec709<->XYZ matrices, EXIF whitelist); values are the
standard public ones.
"""

import numpy as np

from raw2film_tpu_torch.config import DEFAULT_DTYPE

RAW_EXTENSIONS = (
    ".rw2",
    ".dng",
    ".crw",
    ".cr2",
    ".cr3",
    ".nef",
    ".orf",
    ".ori",
    ".raf",
    ".rwl",
    ".pef",
    ".ptx",
    ".arw",
)
"""RAW file extensions accepted by the batch scanner."""

FORMATS = {
    "110": (17, 13),
    "135-half": (24, 18),
    "135": (36, 24),
    "xpan": (65, 24),
    "120-4.5": (56, 42),
    "120-6": (56, 56),
    "120": (70, 56),
    "120-9": (83, 56),
    "4x5": (127, 101.6),
    "5x7": (177.8, 127),
    "8x10": (254, 203.2),
    "11x14": (355.6, 279.4),
    "super16": (12.42, 7.44),
    "scope": (24.89, 10.4275),
    "flat": (24.89, 13.454),
    "academy": (24.89, 18.7),
    "super8": (5.79, 4.01),
    "8mm": (4.5, 3.3),
    "65mm": (48.56, 22.1),
    "IMAX": (70.41, 52.63),
}
"""Film frame formats: name -> (width mm, height mm)."""

# sRGB / Rec.709 primaries with D65 white (IEC 61966-2-1 standard matrices).
REC709_TO_XYZ = np.array(
    [
        [0.4124564, 0.3575761, 0.1804375],
        [0.2126729, 0.7151522, 0.0721750],
        [0.0193339, 0.1191920, 0.9503041],
    ],
    dtype=DEFAULT_DTYPE,
)

XYZ_TO_REC709 = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=DEFAULT_DTYPE,
)

# Display P3 (SMPTE EG 432-1 primaries, D65), XYZ -> linear P3.
XYZ_TO_DISPLAY_P3 = np.array(
    [
        [2.493496911941425, -0.9313836179191239, -0.40271078445071684],
        [-0.8294889695615747, 1.7626640603183463, 0.023624685841943577],
        [0.03584583024378447, -0.07617238926804182, 0.9568845240076872],
    ],
    dtype=DEFAULT_DTYPE,
)

REC709_TO_DISPLAY_P3 = np.array(
    [
        [0.822462, 0.177538, 0.000000],
        [0.033194, 0.966806, 0.000000],
        [0.017083, 0.072397, 0.910520],
    ],
    dtype=DEFAULT_DTYPE,
)

METADATA_KEYS = frozenset(
    {
        "Make",
        "Model",
        "LensMake",
        "LensModel",
        "FocalLength",
        "FocalLengthIn35mmFormat",
        "FNumber",
        "ApertureValue",
        "MaxApertureValue",
        "ExposureTime",
        "ShutterSpeedValue",
        "ISO",
        "SensitivityType",
        "ExposureProgram",
        "ExposureMode",
        "ExposureCompensation",
        "MeteringMode",
        "LightSource",
        "Flash",
        "WhiteBalance",
        "ColorSpace",
        "DateTimeOriginal",
        "CreateDate",
        "ModifyDate",
        "OffsetTime",
        "OffsetTimeOriginal",
        "OffsetTimeDigitized",
        "SubSecTime",
        "SubSecTimeOriginal",
        "SubSecTimeDigitized",
        "GPSLatitude",
        "GPSLatitudeRef",
        "GPSLongitude",
        "GPSLongitudeRef",
        "GPSAltitude",
        "GPSAltitudeRef",
        "GPSTimeStamp",
        "GPSDateStamp",
        "GPSVersionID",
        "GPSImgDirection",
        "GPSImgDirectionRef",
        "Software",
        "ProcessingSoftware",
        "Copyright",
        "Contrast",
        "Saturation",
        "BrightnessValue",
        "LightValue",
        "DigitalZoomRatio",
        "SceneCaptureType",
        "SceneType",
        "FileSource",
        "SensingMethod",
        "SubjectDistance",
        "SubjectDistanceRange",
        "CompositeImage",
        "ResolutionUnit",
        "XResolution",
        "YResolution",
        "FocalPlaneXResolution",
        "FocalPlaneYResolution",
        "FocalPlaneResolutionUnit",
        "YCbCrPositioning",
        "ComponentsConfiguration",
        "InteropIndex",
        "Compression",
        "ThumbnailLength",
        "ExifImageWidth",
        "SensorWidth",
        "SensorHeight",
        "SensorLeftBorder",
        "SensorTopBorder",
        "SensorRightBorder",
        "SensorBottomBorder",
    }
)
"""EXIF tags preserved on export (capability parity with reference
src/raw2film/data.py METADATA_KEYS)."""

CANVAS_MODES = (
    "No",
    "Proportional white",
    "Proportional black",
    "Uniform white",
    "Uniform black",
    "Fixed white",
    "Fixed black",
)
"""Available canvas/border modes (reference: src/raw2film/raw_conversion.py:21-29)."""
