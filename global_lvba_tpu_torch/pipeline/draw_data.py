"""Data of pipeline/draw.py, written by scripts/make_draw_data.py from cv2's
renders (see there): FONT_HERSHEY_SIMPLEX's anti-aliased glyph coverage.
Do not edit."""

# (scale, thickness, code, dx, dy, advance, h, w, offset into GLYPH_BYTES)
GLYPHS = [
    (0.5, 1, 32, 0, 0, 3, 0, 0, 0),
    (0.5, 1, 33, 1, -11, 3, 11, 2, 0),
    (0.5, 1, 34, 0, -11, 5, 4, 5, 22),
    (0.5, 1, 35, 0, -10, 10, 10, 10, 42),
    (0.5, 1, 36, 0, -12, 9, 14, 9, 142),
    (0.5, 1, 37, 0, -11, 11, 12, 11, 268),
    (0.5, 1, 38, 0, -11, 10, 12, 10, 400),
    (0.5, 1, 39, 0, -11, 3, 4, 3, 520),
    (0.5, 1, 40, 2, -13, 9, 15, 5, 532),
    (0.5, 1, 41, 2, -13, 9, 15, 5, 607),
    (0.5, 1, 42, 0, -11, 6, 5, 6, 682),
    (0.5, 1, 43, 0, -9, 9, 9, 9, 712),
    (0.5, 1, 44, 0, -2, 3, 4, 3, 793),
    (0.5, 1, 45, 1, -6, 7, 3, 6, 805),
    (0.5, 1, 46, 1, -2, 3, 2, 2, 823),
    (0.5, 1, 47, 0, -12, 7, 14, 7, 827),
    (0.5, 1, 48, 0, -11, 9, 12, 9, 925),
    (0.5, 1, 49, 1, -11, 9, 11, 8, 1033),
    (0.5, 1, 50, 0, -11, 9, 11, 9, 1121),
    (0.5, 1, 51, 0, -11, 9, 12, 9, 1220),
    (0.5, 1, 52, 0, -11, 9, 11, 9, 1328),
    (0.5, 1, 53, 0, -11, 9, 12, 9, 1427),
    (0.5, 1, 54, 0, -11, 9, 12, 9, 1535),
    (0.5, 1, 55, 1, -11, 9, 11, 8, 1643),
    (0.5, 1, 56, 0, -11, 9, 12, 9, 1731),
    (0.5, 1, 57, 0, -11, 9, 11, 9, 1839),
    (0.5, 1, 58, 1, -7, 3, 7, 2, 1938),
    (0.5, 1, 59, 0, -7, 4, 9, 3, 1952),
    (0.5, 1, 60, 0, -9, 7, 9, 7, 1979),
    (0.5, 1, 61, 1, -7, 8, 5, 7, 2042),
    (0.5, 1, 62, 1, -9, 7, 9, 6, 2077),
    (0.5, 1, 63, 0, -11, 7, 11, 8, 2131),
    (0.5, 1, 64, 0, -10, 12, 12, 12, 2219),
    (0.5, 1, 65, 0, -11, 10, 11, 10, 2363),
    (0.5, 1, 66, 1, -11, 10, 11, 9, 2473),
    (0.5, 1, 67, 0, -11, 9, 12, 10, 2572),
    (0.5, 1, 68, 1, -11, 10, 11, 9, 2692),
    (0.5, 1, 69, 1, -11, 9, 11, 8, 2791),
    (0.5, 1, 70, 1, -11, 8, 11, 8, 2879),
    (0.5, 1, 71, 0, -11, 10, 12, 10, 2967),
    (0.5, 1, 72, 1, -11, 10, 11, 9, 3087),
    (0.5, 1, 73, 1, -11, 4, 11, 2, 3186),
    (0.5, 1, 74, 0, -11, 9, 12, 9, 3208),
    (0.5, 1, 75, 1, -11, 9, 11, 8, 3316),
    (0.5, 1, 76, 1, -11, 8, 11, 8, 3404),
    (0.5, 1, 77, 1, -11, 11, 11, 10, 3492),
    (0.5, 1, 78, 1, -11, 10, 11, 9, 3602),
    (0.5, 1, 79, 0, -11, 10, 12, 10, 3701),
    (0.5, 1, 80, 1, -11, 9, 11, 9, 3821),
    (0.5, 1, 81, 0, -11, 10, 12, 10, 3920),
    (0.5, 1, 82, 1, -11, 9, 11, 9, 4040),
    (0.5, 1, 83, 0, -11, 9, 12, 9, 4139),
    (0.5, 1, 84, 0, -11, 8, 11, 9, 4247),
    (0.5, 1, 85, 1, -11, 10, 12, 9, 4346),
    (0.5, 1, 86, 0, -11, 9, 11, 10, 4454),
    (0.5, 1, 87, 0, -11, 11, 11, 12, 4564),
    (0.5, 1, 88, 0, -11, 9, 11, 10, 4696),
    (0.5, 1, 89, 0, -11, 9, 11, 10, 4806),
    (0.5, 1, 90, 0, -11, 8, 11, 9, 4916),
    (0.5, 1, 91, 1, -12, 4, 15, 4, 5015),
    (0.5, 1, 92, 0, -12, 7, 14, 7, 5075),
    (0.5, 1, 93, 0, -12, 4, 15, 4, 5173),
    (0.5, 1, 94, 1, -11, 6, 3, 5, 5233),
    (0.5, 1, 95, 0, -1, 11, 2, 11, 5248),
    (0.5, 1, 96, 1, -11, 5, 3, 4, 5270),
    (0.5, 1, 97, 0, -8, 8, 9, 8, 5282),
    (0.5, 1, 98, 1, -11, 8, 12, 8, 5354),
    (0.5, 1, 99, 0, -8, 8, 9, 8, 5450),
    (0.5, 1, 100, 0, -11, 8, 12, 8, 5522),
    (0.5, 1, 101, 0, -8, 8, 9, 8, 5618),
    (0.5, 1, 102, 0, -12, 5, 12, 6, 5690),
    (0.5, 1, 103, 0, -8, 8, 12, 8, 5762),
    (0.5, 1, 104, 1, -11, 9, 11, 8, 5858),
    (0.5, 1, 105, 0, -11, 3, 11, 3, 5946),
    (0.5, 1, 106, -1, -11, 3, 14, 4, 5979),
    (0.5, 1, 107, 1, -11, 7, 11, 7, 6035),
    (0.5, 1, 108, 1, -11, 3, 11, 2, 6112),
    (0.5, 1, 109, 1, -8, 13, 8, 12, 6134),
    (0.5, 1, 110, 1, -8, 9, 8, 8, 6230),
    (0.5, 1, 111, 0, -8, 8, 9, 8, 6294),
    (0.5, 1, 112, 1, -8, 8, 11, 8, 6366),
    (0.5, 1, 113, 0, -8, 8, 11, 8, 6454),
    (0.5, 1, 114, 1, -8, 5, 8, 5, 6542),
    (0.5, 1, 115, 0, -8, 7, 9, 7, 6582),
    (0.5, 1, 116, 0, -11, 5, 11, 6, 6645),
    (0.5, 1, 117, 1, -8, 9, 9, 7, 6711),
    (0.5, 1, 118, 0, -8, 8, 8, 8, 6774),
    (0.5, 1, 119, 0, -8, 12, 8, 12, 6838),
    (0.5, 1, 120, 0, -8, 8, 8, 8, 6934),
    (0.5, 1, 121, 0, -8, 8, 11, 8, 6998),
    (0.5, 1, 122, 0, -8, 7, 8, 8, 7086),
    (0.5, 1, 123, 0, -12, 5, 15, 6, 7150),
    (0.5, 1, 124, 1, -14, 3, 18, 2, 7240),
    (0.5, 1, 125, 0, -12, 5, 15, 6, 7276),
    (0.5, 1, 126, 1, -6, 8, 3, 7, 7366),
    (0.6, 1, 32, 0, 0, 4, 0, 0, 7387),
    (0.6, 1, 33, 1, -12, 4, 12, 3, 7387),
    (0.6, 1, 34, 0, -13, 6, 5, 6, 7423),
    (0.6, 1, 35, 0, -12, 11, 12, 12, 7453),
    (0.6, 1, 36, 0, -14, 10, 16, 10, 7597),
    (0.6, 1, 37, 0, -13, 13, 14, 13, 7757),
    (0.6, 1, 38, 0, -13, 11, 14, 12, 7939),
    (0.6, 1, 39, 0, -13, 3, 5, 3, 8107),
    (0.6, 1, 40, 3, -14, 10, 16, 5, 8122),
    (0.6, 1, 41, 2, -14, 10, 16, 6, 8202),
    (0.6, 1, 42, 0, -13, 7, 6, 7, 8298),
    (0.6, 1, 43, 0, -10, 10, 10, 10, 8340),
    (0.6, 1, 44, 0, -3, 4, 5, 4, 8440),
    (0.6, 1, 45, 1, -6, 8, 2, 7, 8460),
    (0.6, 1, 46, 1, -3, 4, 3, 3, 8474),
    (0.6, 1, 47, 0, -14, 8, 16, 8, 8483),
    (0.6, 1, 48, 0, -13, 10, 14, 10, 8611),
    (0.6, 1, 49, 1, -12, 10, 12, 9, 8751),
    (0.6, 1, 50, 1, -13, 10, 13, 9, 8859),
    (0.6, 1, 51, 0, -12, 10, 13, 10, 8976),
    (0.6, 1, 52, 0, -12, 10, 12, 11, 9106),
    (0.6, 1, 53, 1, -12, 10, 13, 9, 9238),
    (0.6, 1, 54, 0, -12, 10, 13, 10, 9355),
    (0.6, 1, 55, 1, -12, 10, 12, 9, 9485),
    (0.6, 1, 56, 0, -13, 10, 14, 10, 9593),
    (0.6, 1, 57, 0, -13, 10, 13, 10, 9733),
    (0.6, 1, 58, 1, -8, 4, 8, 3, 9863),
    (0.6, 1, 59, 1, -8, 4, 10, 3, 9887),
    (0.6, 1, 60, 0, -11, 8, 11, 8, 9917),
    (0.6, 1, 61, 1, -8, 9, 6, 8, 10005),
    (0.6, 1, 62, 1, -11, 8, 11, 7, 10053),
    (0.6, 1, 63, 0, -13, 9, 13, 9, 10130),
    (0.6, 1, 64, 0, -12, 14, 15, 14, 10247),
    (0.6, 1, 65, 0, -12, 11, 12, 12, 10457),
    (0.6, 1, 66, 1, -12, 11, 12, 10, 10601),
    (0.6, 1, 67, 1, -13, 11, 14, 10, 10721),
    (0.6, 1, 68, 1, -12, 11, 12, 10, 10861),
    (0.6, 1, 69, 1, -12, 10, 12, 9, 10981),
    (0.6, 1, 70, 1, -12, 10, 12, 9, 11089),
    (0.6, 1, 71, 1, -13, 11, 14, 10, 11197),
    (0.6, 1, 72, 1, -12, 12, 12, 10, 11337),
    (0.6, 1, 73, 1, -12, 4, 12, 3, 11457),
    (0.6, 1, 74, 0, -12, 10, 13, 10, 11493),
    (0.6, 1, 75, 1, -12, 10, 12, 9, 11623),
    (0.6, 1, 76, 1, -12, 9, 12, 9, 11731),
    (0.6, 1, 77, 1, -12, 13, 12, 12, 11839),
    (0.6, 1, 78, 1, -12, 11, 12, 10, 11983),
    (0.6, 1, 79, 1, -13, 11, 14, 10, 12103),
    (0.6, 1, 80, 1, -12, 10, 12, 10, 12243),
    (0.6, 1, 81, 1, -13, 11, 15, 10, 12363),
    (0.6, 1, 82, 1, -12, 11, 12, 10, 12513),
    (0.6, 1, 83, 0, -13, 10, 14, 10, 12633),
    (0.6, 1, 84, 0, -12, 9, 12, 10, 12773),
    (0.6, 1, 85, 1, -12, 12, 13, 10, 12893),
    (0.6, 1, 86, 0, -12, 11, 12, 11, 13023),
    (0.6, 1, 87, 0, -12, 13, 12, 13, 13155),
    (0.6, 1, 88, 0, -12, 10, 12, 11, 13311),
    (0.6, 1, 89, 0, -12, 11, 12, 11, 13443),
    (0.6, 1, 90, 0, -12, 10, 12, 10, 13575),
    (0.6, 1, 91, 1, -14, 5, 17, 5, 13695),
    (0.6, 1, 92, 0, -14, 8, 16, 8, 13780),
    (0.6, 1, 93, 0, -14, 5, 17, 5, 13908),
    (0.6, 1, 94, 1, -13, 7, 4, 6, 13993),
    (0.6, 1, 95, 1, -1, 12, 2, 11, 14017),
    (0.6, 1, 96, 1, -13, 5, 3, 4, 14039),
    (0.6, 1, 97, 0, -10, 9, 11, 9, 14051),
    (0.6, 1, 98, 1, -13, 10, 14, 9, 14150),
    (0.6, 1, 99, 0, -10, 9, 11, 9, 14276),
    (0.6, 1, 100, 0, -13, 10, 14, 9, 14375),
    (0.6, 1, 101, 0, -10, 9, 11, 9, 14501),
    (0.6, 1, 102, 0, -13, 6, 13, 7, 14600),
    (0.6, 1, 103, 0, -10, 10, 14, 9, 14691),
    (0.6, 1, 104, 1, -13, 10, 13, 9, 14817),
    (0.6, 1, 105, 1, -13, 4, 13, 2, 14934),
    (0.6, 1, 106, -1, -13, 4, 17, 5, 14960),
    (0.6, 1, 107, 1, -13, 8, 13, 8, 15045),
    (0.6, 1, 108, 1, -13, 4, 13, 2, 15149),
    (0.6, 1, 109, 1, -10, 15, 10, 14, 15175),
    (0.6, 1, 110, 1, -10, 10, 10, 9, 15315),
    (0.6, 1, 111, 0, -10, 9, 11, 9, 15405),
    (0.6, 1, 112, 1, -10, 10, 14, 9, 15504),
    (0.6, 1, 113, 0, -10, 10, 14, 9, 15630),
    (0.6, 1, 114, 1, -9, 6, 9, 6, 15756),
    (0.6, 1, 115, 0, -10, 8, 11, 8, 15810),
    (0.6, 1, 116, 0, -13, 6, 13, 7, 15898),
    (0.6, 1, 117, 1, -9, 10, 10, 9, 15989),
    (0.6, 1, 118, 0, -9, 9, 9, 9, 16079),
    (0.6, 1, 119, 0, -9, 13, 9, 14, 16160),
    (0.6, 1, 120, 0, -9, 9, 9, 9, 16286),
    (0.6, 1, 121, 0, -9, 9, 13, 9, 16367),
    (0.6, 1, 122, 0, -9, 8, 9, 9, 16484),
    (0.6, 1, 123, 0, -14, 6, 17, 6, 16565),
    (0.6, 1, 124, 1, -16, 3, 20, 2, 16667),
    (0.6, 1, 125, 0, -14, 6, 17, 6, 16707),
    (0.6, 1, 126, 1, -7, 9, 3, 8, 16809),
    (0.6, 2, 32, 0, 0, 4, 0, 0, 16833),
    (0.6, 2, 33, 1, -12, 4, 12, 3, 16833),
    (0.6, 2, 34, 0, -13, 7, 6, 7, 16869),
    (0.6, 2, 35, 0, -12, 11, 12, 11, 16911),
    (0.6, 2, 36, 0, -14, 11, 16, 11, 17043),
    (0.6, 2, 37, 0, -13, 13, 14, 13, 17219),
    (0.6, 2, 38, 0, -13, 12, 14, 13, 17401),
    (0.6, 2, 39, 0, -13, 4, 6, 4, 17583),
    (0.6, 2, 40, 3, -14, 11, 16, 6, 17607),
    (0.6, 2, 41, 2, -14, 11, 16, 7, 17703),
    (0.6, 2, 42, 0, -13, 7, 7, 7, 17815),
    (0.6, 2, 43, 0, -10, 10, 10, 10, 17864),
    (0.6, 2, 44, 0, -3, 4, 5, 4, 17964),
    (0.6, 2, 45, 1, -7, 8, 3, 7, 17984),
    (0.6, 2, 46, 0, -3, 4, 3, 4, 18005),
    (0.6, 2, 47, 0, -14, 8, 16, 9, 18017),
    (0.6, 2, 48, 0, -13, 11, 14, 11, 18161),
    (0.6, 2, 49, 1, -12, 11, 12, 10, 18315),
    (0.6, 2, 50, 0, -13, 11, 13, 11, 18435),
    (0.6, 2, 51, 0, -12, 11, 13, 11, 18578),
    (0.6, 2, 52, 0, -12, 11, 12, 11, 18721),
    (0.6, 2, 53, 0, -12, 11, 13, 11, 18853),
    (0.6, 2, 54, 0, -12, 11, 13, 11, 18996),
    (0.6, 2, 55, 1, -12, 11, 12, 9, 19139),
    (0.6, 2, 56, 0, -13, 11, 14, 11, 19247),
    (0.6, 2, 57, 0, -13, 11, 13, 11, 19401),
    (0.6, 2, 58, 1, -9, 4, 9, 3, 19544),
    (0.6, 2, 59, 0, -9, 5, 11, 5, 19571),
    (0.6, 2, 60, 0, -11, 8, 11, 8, 19626),
    (0.6, 2, 61, 1, -9, 9, 7, 8, 19714),
    (0.6, 2, 62, 1, -11, 8, 11, 8, 19770),
    (0.6, 2, 63, 0, -13, 9, 13, 10, 19858),
    (0.6, 2, 64, 0, -12, 14, 15, 14, 19988),
    (0.6, 2, 65, 0, -12, 12, 12, 12, 20198),
    (0.6, 2, 66, 1, -12, 11, 12, 11, 20342),
    (0.6, 2, 67, 0, -13, 11, 14, 12, 20474),
    (0.6, 2, 68, 1, -12, 12, 12, 11, 20642),
    (0.6, 2, 69, 1, -12, 10, 12, 9, 20774),
    (0.6, 2, 70, 1, -12, 10, 12, 9, 20882),
    (0.6, 2, 71, 0, -13, 12, 14, 12, 20990),
    (0.6, 2, 72, 1, -12, 12, 12, 11, 21158),
    (0.6, 2, 73, 1, -12, 5, 12, 4, 21290),
    (0.6, 2, 74, 0, -12, 11, 13, 11, 21338),
    (0.6, 2, 75, 1, -12, 11, 12, 10, 21481),
    (0.6, 2, 76, 1, -12, 10, 12, 9, 21601),
    (0.6, 2, 77, 1, -12, 14, 12, 12, 21709),
    (0.6, 2, 78, 1, -12, 12, 12, 10, 21853),
    (0.6, 2, 79, 0, -13, 12, 14, 12, 21973),
    (0.6, 2, 80, 1, -12, 11, 12, 10, 22141),
    (0.6, 2, 81, 0, -13, 12, 15, 12, 22261),
    (0.6, 2, 82, 1, -12, 11, 12, 11, 22441),
    (0.6, 2, 83, 0, -13, 11, 14, 11, 22573),
    (0.6, 2, 84, 0, -12, 10, 12, 11, 22727),
    (0.6, 2, 85, 1, -12, 12, 13, 11, 22859),
    (0.6, 2, 86, 0, -12, 11, 12, 12, 23002),
    (0.6, 2, 87, 0, -12, 14, 12, 14, 23146),
    (0.6, 2, 88, 0, -12, 11, 12, 12, 23314),
    (0.6, 2, 89, 0, -12, 11, 12, 12, 23458),
    (0.6, 2, 90, 0, -12, 10, 12, 11, 23602),
    (0.6, 2, 91, 1, -14, 6, 17, 5, 23734),
    (0.6, 2, 92, 0, -14, 8, 16, 9, 23819),
    (0.6, 2, 93, 0, -14, 6, 17, 6, 23963),
    (0.6, 2, 94, 0, -13, 7, 3, 7, 24065),
    (0.6, 2, 95, 0, -2, 12, 4, 12, 24086),
    (0.6, 2, 96, 1, -13, 6, 3, 5, 24134),
    (0.6, 2, 97, 0, -10, 9, 11, 9, 24149),
    (0.6, 2, 98, 1, -13, 10, 14, 9, 24248),
    (0.6, 2, 99, 0, -10, 9, 11, 10, 24374),
    (0.6, 2, 100, 0, -13, 10, 14, 10, 24484),
    (0.6, 2, 101, 0, -10, 10, 11, 10, 24624),
    (0.6, 2, 102, 0, -13, 7, 13, 8, 24734),
    (0.6, 2, 103, 0, -10, 10, 14, 10, 24838),
    (0.6, 2, 104, 1, -13, 10, 13, 9, 24978),
    (0.6, 2, 105, 1, -13, 4, 13, 3, 25095),
    (0.6, 2, 106, -1, -13, 4, 17, 5, 25134),
    (0.6, 2, 107, 1, -13, 9, 13, 9, 25219),
    (0.6, 2, 108, 1, -13, 4, 13, 3, 25336),
    (0.6, 2, 109, 1, -10, 15, 10, 14, 25375),
    (0.6, 2, 110, 1, -10, 10, 10, 9, 25515),
    (0.6, 2, 111, 0, -10, 10, 11, 10, 25605),
    (0.6, 2, 112, 1, -10, 10, 14, 9, 25715),
    (0.6, 2, 113, 0, -10, 10, 14, 10, 25841),
    (0.6, 2, 114, 1, -9, 7, 9, 7, 25981),
    (0.6, 2, 115, 0, -10, 9, 11, 9, 26044),
    (0.6, 2, 116, 0, -13, 7, 13, 8, 26143),
    (0.6, 2, 117, 0, -9, 10, 10, 10, 26247),
    (0.6, 2, 118, 0, -9, 10, 9, 10, 26347),
    (0.6, 2, 119, 0, -9, 14, 9, 14, 26437),
    (0.6, 2, 120, 0, -9, 9, 9, 10, 26563),
    (0.6, 2, 121, 0, -9, 10, 13, 10, 26653),
    (0.6, 2, 122, 0, -9, 9, 9, 9, 26783),
    (0.6, 2, 123, 0, -14, 7, 17, 7, 26864),
    (0.6, 2, 124, 1, -16, 4, 20, 3, 26983),
    (0.6, 2, 125, 0, -14, 7, 17, 7, 27043),
    (0.6, 2, 126, 1, -7, 9, 4, 8, 27162),
    (0.5, 2, 32, 0, 0, 3, 0, 0, 27194),
    (0.5, 2, 33, 0, -11, 4, 11, 4, 27194),
    (0.5, 2, 34, 0, -11, 6, 5, 6, 27238),
    (0.5, 2, 35, 0, -10, 10, 10, 10, 27268),
    (0.5, 2, 36, 0, -12, 9, 14, 10, 27368),
    (0.5, 2, 37, 0, -11, 11, 12, 12, 27508),
    (0.5, 2, 38, 0, -11, 10, 12, 11, 27652),
    (0.5, 2, 39, 0, -11, 3, 5, 3, 27784),
    (0.5, 2, 40, 2, -13, 9, 15, 6, 27799),
    (0.5, 2, 41, 2, -13, 9, 15, 6, 27889),
    (0.5, 2, 42, 0, -11, 6, 6, 6, 27979),
    (0.5, 2, 43, 0, -9, 9, 9, 9, 28015),
    (0.5, 2, 44, 0, -3, 4, 5, 4, 28096),
    (0.5, 2, 45, 0, -6, 7, 3, 7, 28116),
    (0.5, 2, 46, 0, -3, 4, 3, 4, 28137),
    (0.5, 2, 47, 0, -12, 7, 14, 8, 28149),
    (0.5, 2, 48, 0, -11, 9, 12, 10, 28261),
    (0.5, 2, 49, 1, -11, 9, 11, 8, 28381),
    (0.5, 2, 50, 0, -11, 9, 11, 9, 28469),
    (0.5, 2, 51, 0, -11, 9, 12, 10, 28568),
    (0.5, 2, 52, 0, -11, 9, 11, 10, 28688),
    (0.5, 2, 53, 0, -11, 9, 12, 10, 28798),
    (0.5, 2, 54, 0, -11, 9, 12, 10, 28918),
    (0.5, 2, 55, 1, -11, 9, 11, 8, 29038),
    (0.5, 2, 56, 0, -11, 9, 12, 10, 29126),
    (0.5, 2, 57, 0, -11, 9, 11, 9, 29246),
    (0.5, 2, 58, 0, -8, 4, 8, 4, 29345),
    (0.5, 2, 59, 0, -8, 4, 10, 4, 29377),
    (0.5, 2, 60, 0, -10, 7, 10, 7, 29417),
    (0.5, 2, 61, 0, -8, 8, 7, 8, 29487),
    (0.5, 2, 62, 0, -10, 7, 10, 8, 29543),
    (0.5, 2, 63, 0, -11, 8, 11, 9, 29623),
    (0.5, 2, 64, 0, -11, 12, 13, 12, 29722),
    (0.5, 2, 65, 0, -11, 10, 11, 11, 29878),
    (0.5, 2, 66, 1, -11, 10, 11, 9, 29999),
    (0.5, 2, 67, 0, -11, 10, 12, 10, 30098),
    (0.5, 2, 68, 1, -11, 10, 11, 9, 30218),
    (0.5, 2, 69, 1, -11, 9, 11, 8, 30317),
    (0.5, 2, 70, 1, -11, 9, 11, 8, 30405),
    (0.5, 2, 71, 0, -11, 10, 12, 10, 30493),
    (0.5, 2, 72, 1, -11, 11, 11, 9, 30613),
    (0.5, 2, 73, 1, -11, 4, 11, 3, 30712),
    (0.5, 2, 74, 0, -11, 9, 12, 9, 30745),
    (0.5, 2, 75, 1, -11, 9, 11, 9, 30853),
    (0.5, 2, 76, 1, -11, 8, 11, 8, 30952),
    (0.5, 2, 77, 1, -11, 12, 11, 11, 31040),
    (0.5, 2, 78, 1, -11, 10, 11, 9, 31161),
    (0.5, 2, 79, 0, -11, 10, 12, 10, 31260),
    (0.5, 2, 80, 1, -11, 9, 11, 9, 31380),
    (0.5, 2, 81, 0, -11, 10, 12, 10, 31479),
    (0.5, 2, 82, 1, -11, 10, 11, 9, 31599),
    (0.5, 2, 83, 0, -11, 9, 12, 10, 31698),
    (0.5, 2, 84, 0, -11, 9, 11, 9, 31818),
    (0.5, 2, 85, 1, -11, 10, 12, 9, 31917),
    (0.5, 2, 86, 0, -11, 10, 11, 10, 32025),
    (0.5, 2, 87, 0, -11, 12, 11, 12, 32135),
    (0.5, 2, 88, 0, -11, 10, 11, 10, 32267),
    (0.5, 2, 89, 0, -11, 10, 11, 10, 32377),
    (0.5, 2, 90, 0, -11, 9, 11, 9, 32487),
    (0.5, 2, 91, 0, -12, 5, 15, 6, 32586),
    (0.5, 2, 92, 0, -12, 7, 14, 8, 32676),
    (0.5, 2, 93, 0, -12, 5, 15, 5, 32788),
    (0.5, 2, 94, 0, -12, 6, 4, 6, 32863),
    (0.5, 2, 95, 0, -1, 11, 2, 11, 32887),
    (0.5, 2, 96, 0, -12, 5, 4, 5, 32909),
    (0.5, 2, 97, 0, -8, 8, 9, 8, 32929),
    (0.5, 2, 98, 0, -11, 9, 12, 9, 33001),
    (0.5, 2, 99, 0, -8, 8, 9, 9, 33109),
    (0.5, 2, 100, 0, -11, 9, 12, 9, 33190),
    (0.5, 2, 101, 0, -8, 8, 9, 9, 33298),
    (0.5, 2, 102, 0, -12, 6, 12, 7, 33379),
    (0.5, 2, 103, 0, -8, 9, 12, 9, 33463),
    (0.5, 2, 104, 0, -11, 9, 11, 9, 33571),
    (0.5, 2, 105, 0, -11, 4, 11, 4, 33670),
    (0.5, 2, 106, -1, -11, 4, 14, 5, 33714),
    (0.5, 2, 107, 0, -11, 8, 11, 9, 33784),
    (0.5, 2, 108, 0, -11, 4, 11, 4, 33883),
    (0.5, 2, 109, 0, -8, 13, 8, 13, 33927),
    (0.5, 2, 110, 0, -8, 9, 8, 9, 34031),
    (0.5, 2, 111, 0, -8, 9, 9, 9, 34103),
    (0.5, 2, 112, 0, -8, 9, 11, 9, 34184),
    (0.5, 2, 113, 0, -8, 9, 11, 9, 34283),
    (0.5, 2, 114, 0, -8, 6, 8, 7, 34382),
    (0.5, 2, 115, 0, -8, 8, 9, 8, 34438),
    (0.5, 2, 116, 0, -11, 6, 11, 7, 34510),
    (0.5, 2, 117, 0, -8, 9, 9, 9, 34587),
    (0.5, 2, 118, 0, -8, 8, 8, 9, 34668),
    (0.5, 2, 119, 0, -8, 12, 8, 12, 34740),
    (0.5, 2, 120, 0, -8, 8, 8, 9, 34836),
    (0.5, 2, 121, 0, -8, 8, 11, 9, 34908),
    (0.5, 2, 122, 0, -8, 8, 8, 8, 35007),
    (0.5, 2, 123, 0, -12, 6, 15, 6, 35071),
    (0.5, 2, 124, 0, -14, 3, 18, 3, 35161),
    (0.5, 2, 125, 0, -12, 6, 15, 6, 35215),
    (0.5, 2, 126, 0, -6, 8, 3, 8, 35305),
]

# the glyphs' coverage bytes, zlib-compressed, base64
GLYPH_BLOB = (
    "eNqsfQVgVcfS8N57405IAklw9+AUdy9WrHhxKy4BQnAvUqy4u3sCBJcQSAgSICEuhLjL9TP/zO65"
    "gde+16/f+78lnDO598ju7PjMbsY2j179/b+prQ+OKz7kerTV8tnuMPjpBZW+7YWdbE+ZX/ozxgb+"
    "zqwC3RBgOw+w+noLxn6/nBx++bn68gw2ZUXRiRVPPq3oy5iNVIcd/50u8zJYsqBpjDWJTzXGx+vT"
    "41vY9zn1su9oGN3XgbHDO9gPxUq6rmsN5kEvwKbKb8LPdpNgVy08/5SfcjsVFjD25j5jigNSRVvD"
    "MvzYfnxZdi9vTmlx7b583Y2hFgTaDrtqfOkmHtVGmtM9vQ4CzsVrHVI/D6o38Lq+OatyoxAMwd34"
    "xdBFXKlYVIZOLlOHWOGp7FyVMv7wvTOMmT06wlpFsTIaK7Y+zIZ1e8NswKFXHvbLNqX73McVMofR"
    "bR1PbK//Yo9Fc3P+rG2vm6UGp9SkrudU3baebd7EWNWcAezidDbzHLMK3crYsv3siDfzfYI3uN/L"
    "vOPC5MZH4DB1x3gOWLxOOJJynaAOUJt1Bk+EGoIXG6u1pS5f+7hGM4XfNhmkPoz1ac8WapeGBzmx"
    "5EXW2mWsTFhwf6mOm/QTjuuN8SxjL9//4Dniq/6tC3Pz10DGlvLBIfSWsvwZOOM43zjbONeE0UqM"
    "rdNdYv0NA83YyVP4yVecRoWxB/YP2jLmCU3xHmjJmCV0wm/VA/EQtAYPqz4hCj2SAvG1NTcuc6WH"
    "zZDu4mcNvxJJTEnEQ32ohlRCz1EYseesYCQeNIMR39CVMTdoxlh3nR1jxx4zrwu6LmzAPj5PA1It"
    "mPmVefGzfF3Ox0HgKtY8K/CBHet1seoDPuOzysh4LOz4PWDu6elZNNjT034EiHZSYWdnV9TLzs78"
    "rxdTm+dOx1PrbaSpXoVOZq7MFZ/goSimexuVq1q1ahXl3S3F9/i1I3bQURk5j07di53pdP0QHSsZ"
    "OCFveEFHq4xRdBqdbkmnl+vp2NRQkU5HrtGxdDGnyPmfFXSqUkXuivv0Xd4N8NwoVXoKgGh6mFyH"
    "HYRMe1vpALOKnQLd6sIINuoPD5jWFPqyoHoOMKcx9G/6iDnC7HKw4PAQ1gxGKbJDo83ZMmjEVgO0"
    "W53zBJFyDEBzzZUTv4cgXKsZP/J+h8BVYsms0Cg6z9hnFXhVdOYfnev26RMe1KdP6eMC10OQYKbv"
    "mkVc6B6T7ZelRgran1WRWYS9Zcx/A368XsdFAFM+ey94cYfE+6E8LHHyVh6VpsnnmfyCg+DfB5ud"
    "pU68ojUb5ENtMmO7QkND30O4eM7RnHoc+E3Tnp8XGAeLcRoh42YNgipUHxqSZS863xV6VQ5GemZD"
    "obN5dGTfuhOiki1Ylet6KLpdji4wL6eSJ0Xxi7fA2BQAjsFaRbc4YPH6wlAObPzizIGOhq6MgFKJ"
    "2xgHVsDr588/w7s/2i3Hdgk2jRBUJJ6DEtbgxJjjYhrOIMbaw3sc0E661Vp8PztH7sOG5I23jiGP"
    "saNwdfEFCamwYl38zRdqMo7OBjDIQT8XgWH4yc3cMbWGZyK3257IgfwLjnwQJcMpu6iikLwPYwQu"
    "fPQ/8PMP+mX87BADuvj9KGo3w5EBszLCLC3zTuPHrWBUBZhEM1O8TpG+h+Yep3ul0bfhj5HhOAyf"
    "aMi74cGf4ELv+pnP0gLV0Y/YsiQb/s3bAH5qh8RL7WIM730F3nWkjQInOlln/sF/HS/VFjfd4Scv"
    "EkfUKv+6a1FzPHfK/Xws0DibsdvPUIJuyjFjH+nGoZILW5k/oVa/mIeI3BQkGQkHGJwwoFzrx9me"
    "tYA0j5thckMTYPYuoa/7D48KPFmFi3rQBBJimVk5MeflZ+2eX53oJTfNP7l4CDNLDLRjln45TrVh"
    "BCejLpU5UvpBO0VIZBXmEfrVktUMk74Y+fcWLb2NZwS9B8TzwbH5hrb87KlZTqfMB347xLCubil4"
    "yu5lsO23WElbcYFF7DVDNcZlFDP3bUf0F5zdgClmFvt7sjIBBZNRhPwKXN7Y7Dds5BKn99ewRlzM"
    "nNe15jf+3OhzPrWJjdpQKy0/vnZTak4JOmpTTpSnzx7l0LNU3ppLRKT1Q1NJUnmmPmOsf1pobcej"
    "+tUWLDqiBX64RMwp67lh2ygzFN/Syzv6p2Y9YTqRYe9h1xCDjaAP120BcVyJXchtJOhfTP+JRPGA"
    "EdPEeeFicQ5+J86DbsZ8fbaDaEpxJnZ68zpD9haiZpgS7sFsbJTKackO7M045pNW+Ga1IqWHs97Z"
    "I7V29S8b2OnFNXPY+Iso0zewrRtr5LKh5xi7vJ3tWWGnrlkqp2OfrJif4nuyW4dY/+cxI9c9XYr9"
    "1dbhb+xB2u1XQ/DiflNvp5B4YM0WnLl3ZJKtkAS/zlCInrUGEFKGHXz/7igHbPPnzC50IOgXnaur"
    "dgJBjy8zduk5AtVIZf8IaEmshQtnzlyAjUyVFHIYW8hXxFhzriCgz8E34qEhR/sh7yweiEP3yw4I"
    "eKop6MD8HpOijnsuAHYqlfk9tbZ2Hlx0hPlxwZhaivkF16njNS/rrHzNaq2jANbrHf1CmzdvvTzn"
    "CrtMDBG5hySMTY+V2yYRVdo+g8hn2tRWjO0zIoU5f000Y/EP6c6RUM8VZgviY+Vhokw45UogKw03"
    "/couLcuefSW+PwFlUa5d/6nNaokQM/y1HrJXC3lmy8UeDW1CE6RTv4LQ0HxIqMJ7a9kzJlru9nKo"
    "LICGMFAA5WC0ACrAKAG0hXYCWGm093vfrdvw7cY9fGhZj3yV/BWIPwe/PBSooSHl/YQEYX85a9Ow"
    "3WN+bwdha/fX70O6Yetqd1mons7iud4WfoUk1N47+d2Xr/vzOf0qttXML/kgtgXsP113uYTVLbst"
    "/30SmRM29yDqXm4G0uFuIwoKl1eZNiz2AV1Sd6t7aZhjshRgKqo4fEmzsgQNWrUdRlhpttFXzaEz"
    "e5yCDMmW6mzZT/qrg5r6GLbgr4ND9VLEUnG/TSk+FYM4d3pXF7gsC2P+DjBqsGkRiBiDbebfXnyZ"
    "Y7C0YWi/oX5Bf/53+RGbyDG5xJ3deIctCrqLbrX4Z0CFn0hvDIRm/XCsqBTVFqW+RvZptqt4N6rC"
    "RxIkb+N6xYZLzX6kNz29GxDSq8SFOOO59he0m/3uN0x7hgzrF5f9yI4mBbKdxOTpLpvzSRqgvWTO"
    "J6uv5qI5n7Re6vNmfNK6523rN1iezGf/n+dPZN/0UgoiM7j0HS4+n9LOz1BX2Cq7/eAyyZ9XCMUb"
    "UVr8VJy22+/WxQCm+rj5I0J1jZ1G57sSxE6+jF3DOFRdn1NKQGwI4k5A1D7uvnRZQKFbxCgqIU0b"
    "SAoNhjJ+EGYhgHD1cgHc8tbWE4DZqyAVB1h97VwBsGVFiwRg/rZAAKyxHspcvsRlkAGp2qr3qg0D"
    "yNqwe6ALelz8Fi333QVtUJOl3mQs/DQXUflmjhI3AwZCA3euU1kXaF0WJnNTG34wL9pH0BLwYA8y"
    "yWMKi0XpYrw9qOdZ8MZfR4UbpZgFYlh2pUyCZl43muH8wMBPkOglUF4l/qmM+3U6SwH4JTK/iEGD"
    "JlwwrGJ+urS0hNv4Vr8gmdf+CiABm9qfhvbGrWRo10qGlvdPh1bZNLQ8hWloS+WhxQvzmIa2MdOR"
    "hjalEnUpLzAwCt67CNFZo8BblqGnwwWgjL3B/GK9vTd/UPdFPLx6lVqISoi+aikNFwA7mWQrgHKF"
    "a5hg3EVFyAq1ZuxeSk7NkOK021+NSAqxzxRMsVOqa6ldR9w13pPdLJgv3Fmb3Xm6W8OtODj0kuG1"
    "sFdYc+Pi9hkNyajM/80yOXpIvZ8uGVszzxu5oP/YTXgjZLB08RHNY1VMTAbExcQ05+a2k8wI/3/A"
    "L3ri7uE9CXZc7PH6PDcmocf/Crgaxs0oqOcDZA6eK1DVyXk7reN+zS7GmgRrTBLHgnumLYTn4rio"
    "XD9ynBmbanC3zNnMLQIUIocS8dpyxolEBSji52qRQ1QpKLpe3aRLdqSZVePGI2sJ3XyKuJGuiDvy"
    "4bwYzno1DBBQXW0KIbzafEvxu/WCyi2hjYA7QRMbPXbDBU29+VpL9h518Sc0q868RnH5ntUCpLXP"
    "+9Hf01svfB02y8E4mSz8Fs+XrLzfnhxyW8NyY00v3SodPftDNo4+KjuUHnwMVqDDAwcInqirQ6w+"
    "Bu28Rdzy6T6NVc47QSZq8SZEPPzMzIPf0xMuZZdfpfHivkHKW7236ONI+CCcEuUDg6GN7LT1Do0j"
    "h6WhdjP6WadwUB9DkSMmIUJ8KRDD2IUcm7bTuRnmsaQ0J2J8fLQlO4bmIDIT2lnu+VuY5Wc//jxd"
    "vSVa7vxZfA4u2iDbq5BsJ3Nv+k4TH6dt/yuUsIlrsyVCVzk3JFX1Lge4Dcuq5d/kvbAI/iq8uS3G"
    "rvzcS/qNnz3SQ3hgR3m/gPeALYWx/NxYzyV+H5fRcoRi2MbDhztkBB5onzGDsX/8Pyt+zE9jx1af"
    "sYo/tIuWh0MU4Uv4rzMTOGodC0Scbe9dfqoviZ484TYbG5rD7Vrzr8KYWymsT099K36+cJKf3LyG"
    "HD48Z/CBMLRjt/3j/77xec8bjx3bmc254M58Ig5+KtPPhjWvanv4qNxqfAfeiy7HbC8GIzqRE0rt"
    "Co85V4WxWxH9+r6IMGO9PNGfASS0miuuRkELdvbLjkGjoUUbA14zEVp0gMFmzb9AC8XKImPGMmND"
    "CgDR0Nf+KOYwfv2fzts2fXyHJmK8/tqIjcZVLD4Ur96dq4zfyuVz+fiNjCz1qvH3uQFlHg+LKv2Y"
    "e5JF7AySjLe5sHPi1KNc8jTBHzG1K3/zz3e1jSyLkWzsg+c34wEy8hBaCm9ajxJcue1n5h/Xv/w6"
    "GMgcrhdDrrcIMZiZKG20rLiOB5WcLX779MbnVBA7VLxs9EN9UCkDTqxNUtAPQB7duaB2XLKcDPKE"
    "cTTrQexhUseqWyGIVXguGW6ffFTSTzbnScReVBVrskd3vhFeyrwAOd06Z2IL+H3u3LkJ+9rA+d3Y"
    "xpglU1TOWsXWxTewmqj/iTkvizVmcstf6S57PY5oxvdPgHNMkXWpjiOaechsm95AeND4rktg+9SG"
    "6CCQOfafjmU5k1tu/vTGd+YedrB4+agHmhAHPY7L9ktIUz6uMyEtuDN0PMRFQrNWFRXCbqQPbn4E"
    "QpjrtcLckxdDlANdVUrmf9Es7aola5g3i3VN0aQaTqBEtazfBge8doBpnv903rnu/ZsVOO/ae+OO"
    "6daweHJWrsez+P3k8YE9v24sOP/5HEF0M1zvoLg5XRHA0XF+BEta8eefaJzRfSgujgrOYpt9Gbt/"
    "/j//DzpQfbHhl6lPFinWCrM2fsWfTqp1TxziVzj6ZbRn8cc/fqyKH8JbEo3xyYbR/JJVpELwSm/j"
    "DBaB75+uG7i2V/zqP/+L8Dk/+WTc7Qa1L8eec2dJxo0jPnxNWjwm4TVLuk5eJ2qw/uCZtBYJUkLa"
    "qApdkqgT0liat+7/CaYBs+LhNKvtz4/ZFPZ6qYIlqW+PPYl0mhSPBHP7I0si6TrbaJZEOJwIln8+"
    "R1MEZLTWnCnmPYw5hfS8OX/TsICc+hZFiEXr/C2NoQPJocAfZJqw57yUfIjdjO9XYb2xF7O/Ugix"
    "43m8hmTwmV+2fnq/Cl1XDfH2Rhb/3oysMWX875y3K8Zv4LxdLd6feFtvEQ/eFX/MPYv4fWo03nEl"
    "GeFo952suDXNZORtC3+7YuZudlSzYvQDTZAT5SSQF5vzIMDZoNZAEbQjQcK2Cw1ij5M7V9mAvFgp"
    "UDL4XQ0SvHhY5m3Tednx87+sfzQqSR2yvnUS6dYk0hscN98OHEWsyvm4N0vNlQl+HQZ+WVuWAsPO"
    "buyG9sJYtHPNehxM1P7CI3qn09oVDlG5B71m87N0xhB0HhTuFKPxPEwBnx+gtum46QO8C+rUdROs"
    "nFrx+8/loxcfj7XmQmvE6rDP0pI7FO8fd049n0KRSf96KiZC+C3pI3kUIUm7CifWWApJNje00otd"
    "UcjZRLGjr5EAWbKzEXQk2bOAvUIbYZTWlY0vdmQPz+FVeVOqSSQi/ni1LkrBPf88YSQ8zEW11pfS"
    "IutX43Bu/ugF9Zl1YZ4la4xA3GLWLyWjF/NFV2D7c3Zkz8GDLAgnu7OhbGbXnukeRpTF5jlHsswt"
    "co5kk7A9TTGJExLXbAMMPVBZG/ox1uFpTcbK3P/R7EmYjep+qBXzTDu2JrcquV5GicuTDgYDifWy"
    "KedOpHky1cNP9jbvn5tPz0W1VD17wagbpHHmHGpAAtEmy4c9QgKbqHZlA43V2LvDOEeJm9sBmcGL"
    "s25w18FFDT8JEosXejpfKIBZhaVEZGw1HesEUdvOSk+dOnUHcLPEIeI12XyKK1mVuctg5GZtdwMn"
    "k4pZ7xp5edVhwq7Qo3JXDN+G9uM29RV7Zls4lediavIME9nnE4vw3RUSr3DThIKS1o/f8nAcD9a2"
    "BoqD1wLKR5ilbiXzdpzxKynAKj9Z/FwhZdTf/Use4Wo+dHE1Ckh/zqSemqf4cpviAh3383jGmi88"
    "FCzxiIRfAQ6rj5GslTWfOZdwP+QaOVDlC3/FHhreIGqatKNIksug7g6sfJmoXI0+Ttexo9Ki/YTW"
    "7EQoux73b36uRjNXT3Yr3OxtsTmr7GZZw9pCuj0cxrOs412hLwvbWA/t3bmdbQ9wd6Em0mt9K2GV"
    "Fo5lLpJIGVZE7dQWKD66+kUYhL74DEGPLNjoHYGFO3a8T9mxhWhr5yvs70XB23eQwsLJSbKePjP1"
    "7syZ2vMzf2AVUjMhNyMHsjPWUuwVGrNuILynfuDAZsix/rLII1VamAyDLsdN0AID9zAU3S/pIGU3"
    "Gkp94ZXv1AuGUFsWkEf8vQmGsaQoHkzqU4EdgNPV5NDSEQMEzxZ5P8+Fr0G/VTY7at2AFaWHc4/F"
    "uuBZdThLnNdEOs0uwe1pw7bHarows1URAOoHImLtY5TTEqz7ORlQfQtV9wrMP0ajqZU2iCmiNzZ6"
    "vxB54f1tJQ7UlS19ivIxyZVyBs5syXM2lsellVG/lg30rl80X8ReH2cdrhBxVaGU0y7sTGz1o3nP"
    "RNB/mqbpwveNN0TyLmqms0fLWRkyCp1izqI568tcoB4yxWck9iWBbjNjlKxfLhGu60X12z7f+mgl"
    "n62dTJ+43dUaX9cS8JOsCYMjEritY4/aA/0X/oUiFfX1QbUY+6/gfU6aID8tGtJQebvgZLm807zS"
    "DWHsVBLSgKaxxSX9cPO0M0xVjIgyO2s4T4oimjhf9QyekKkNR7sNOAWpRnqU9xeQYudaHDGSBGRl"
    "TH2r7IaEilSKJIr0iZcFH2EL4Vx7y8JDKOFIJS5Hx47tSKIIGPHMlTemA/+Vf7FCY0FuJnp0VkVk"
    "6fhIJxDzS0OPuaRdxQ/NFn9OozBChVwyf9kZnpObI5HQHgQkAHsglVK0tVPJUXwykH87W6LOnvpA"
    "sYOcbUw171NGVeaaeZMnlJQLybLxVGRucrRTpj6NuZ6xTjn7FGSs78Q8w++ptzBWL6HJHuHVtjwr"
    "m5hocin/A9T848ePyYAHf090xy7BUh+fiX9/B49sCd9GgTR/y+DMUu8yJxjKzDur2FmK4b5znEvm"
    "73YrpRl7a6zy1iCnYjsI8WyevJufh0g8EscePxR+FPDAKdvzhbOSQ4HInM3Q8bCH4tNZ/mtnaMfP"
    "l0Sms7yex3vY6lxul1ukCj9zmCTIr/mwb3QqZ+lZk5dayNuNVFtfYzg/G+AGSlDowRQR+egIpeWa"
    "sY4fx8EiO0D9eHF6JThUBk6wctn2TnCaoFW7cKyn7eCaRUodlGCHWWr2yAeEm6XsIuAIFFeQLJsA"
    "nJ72Hkgit800Qt5h4TTYVBATYn1QwyNXVd8AOf6sXU72Ig40C6hcD4Sxyv4LoKGv70544Ovbarbs"
    "A68tiZ6wqve1EL9FxZxTC1dOfgB7mS/llRVRRea/c496D6c9nJz3BRz9it3gw4XREThLH6hOwjn5"
    "fFE+X+XZvL1QuNoXW91o+aWT2Vqe+tLlW7H2y7BdhiBBONXTIoVX7xGbKkii1Hu5VIXtgPw7Kzia"
    "2sz2vat5W0qetXUwTNGwlEjlbLbVPSYMbsGu74Fbo8acUcc4MvNFqQBZZ3nZAHMuVzLfPbNkvc/K"
    "phlATL7CL+WQDP4q9dogwLrFu5kALd+G28jgFh12jIPtjH79+/e/BFP6s8XyEEEyt6lG7SC0rCC/"
    "brP8XKrf0FNnYjkSQpgVPCYsjGWVQGRkWUuQyXIArN596Tdk/WlgfHgry7iItdiAgs/pqbGxuKA3"
    "zJ/GSypagc+HbBrOdmg5UfowbugJeGTGRnwwQupeHqmyr1Ay8NNFImPMpsIqOahV/EKoJ6t3+VVN"
    "+NZr361B+dta0hzzvQXBFuyGRJ6BD8xRqLnJ4qi/rsjkdrWN+iq7pCeWGgOzWKOsjCVDt+hDUEw1"
    "vJMPX08K1Ks46reKuVfX7rGOWjRUFhNdKJiczZcDbarYOJWspmU3/V6ReE5daZ/4YK9UT773vune"
    "fgJ4/Un1Z67u/FYHmcftyUz9OL73Bl0wuo660jwAXJOdy7XgztEPbBgcqmjbOynJnLL+NJHoII3W"
    "Ra6celD/vqziywc7PisLKwMPN5lprluoA1Uc/8uRFO8P6zg/J7MmU81NBsi7Iw+tgknMWstFU53e"
    "6CF1tQVFrRJ9p9wBtF8+ZaOdozwLbR0lbs30ggVW+ttcCsJM9lDdijG7p1IdViez6MqBOKBwn/v2"
    "oARIEjhh540iAsLGwUYB1CgQkTB0uLPJ/GTPimuGSHVMmp7aC22tYGOdLZqfd8IoRQnGzBW+0PVa"
    "usXnbayNo6kcQ5wah5EFYbZUF4lYrf5C2oXW7tTCxC4cKdf5xTWS88YJTjsL1wXuh2VliKyN523S"
    "iby6o/y1XN7m9JjKWz32p7b4HG8/rrjK2wC5B8FzeP83So8qcTQl53NP1PkM3OChuOEGcjNrvzLO"
    "Yso5xTFtWaVH0j6ctNDkXryMy9n0fBEDZ4678kH/vDFT3TMeHbGiKKtMR6BKrGnwS/c7VTg9C6Xj"
    "Gv2FB1udQouFXXZaEl+UMt6Vo+4mWWvWTDYmunwQuocNNn3FzGr061vPVu7ByBRITQPNFmeRLZ6F"
    "HOrWMxElDGurQ/vJ2Upp7hm9DW24h6zMfnXRozvMN56xxGlsydsWg7Ieod/oag6t2HM01C8+YqWh"
    "gTWiNwv1/5ZHzBnqq5AkLqCV9yCJNTKWZs8PszE5vudytDc+PKDwdDnW4fK1H1rsXIZMULlgj8Bv"
    "7aXU92bpz8e2aT7gj+ITHEfVNt7L1kRf6lIyN9/T0GRtWMlvYVroxkzYWFJwVob3aEofVgvEW+dc"
    "QItmulyQ04spIl8L3k5WESdSsLqS8UT9+vV7cs9rhSxOMyyYMu5jd2rrcEI6y4LSvtCP7SyQK9L2"
    "au0WkWQpfLnRkq2HZVOmLHkMVxHi0ddAyVWG9kEDDpl3yos3Xw+pyckFUOCF121ZvHhtGBw13XEG"
    "6svQQJguQweg3XpYMm7crHuGpxa+PHP4bqfQ3S5iVksdiQYpbrYZc3gpBc5aEQhnUZFSdFj1BroF"
    "SLwKqLW0LC9Y5jWl/p4Je9+g/Fcm6IGRl4e00Pqs5GJQ+Qp6O7813Ju08D7cUDC304kAqUuFhe3O"
    "tRnhQPPx5FikKNi+bNUjAyp50XuXZ9BaHsdkmCdDbnBahpj+5l8gOzgjQz/AQgGpzkKn9bBx/oLd"
    "r+GwknAgJdzwVvL3YtP2RESSOltWaT133Yi0/w3w8gm2KwhcJy7fy/724jXzqdX1lalhlvwuTbP1"
    "8AcpkbVl10MV08V/BbavwDYVAYMeWxT724tlwNfg+Y3GS9vJJbCRkhS30II5PJOezZn3GPyU3jxV"
    "qDwBw+4Y+dy6+rbNCTbdp6b83mx8eR8OvYyJgWu54ltzuHBPnlvw9oVFvBgPWpUO1QdMmeYHOxTM"
    "GedWHyoX55Tl1LWoWKAkuWTOiv3+JygyjJoRocd+1Ax+//ReX1E7yTIvLlZXWw9ef/Pja6zBLopJ"
    "0U1mg1dROwYLZTS0/19DXWFuy7e9CVoL3SpDAAonszCjI7sMt35ZlABo+Nv+lg/SR3G90tNZYMed"
    "J1G9+SSug8MqBBTbYZ8Sp7XaAdiloPl9CFsVfKLRxBUzLiVWEcAsTUJlQQO91PGVBTF0K46vJKii"
    "c1FcRUEVHbI+LlZXMhFMnf9rYAdZyz6uMrVLP3gXdxZfnSkstR6CuaBuLoE7DoH7S/eA4I8fVZSA"
    "/EjwYBjDFEEh6wl294+z6Ae91nG4mTQz7DkTMLuqRddShhsY7jETzMpYf4OFie2+VC9Xry3VOS8q"
    "5B5WI81gpC5r7qKOx75sMkGP9E1lyCvjrbmA3IchowgIXfU6MuSRHdheQOgfXZAhxW2QIVYhH8b7"
    "ijdPkn7mUlaYNPaH40AdOBzFbZB0fKLPB+M0tP2oPNjpnc72uo5HDeZC53ShXNrAUjUPfrE68FsJ"
    "tDlTFLx1gGX+guZ3Qs+lXFObpxmd3MOlx5N/+worER/X0sHwQbbNPW1NUlaXfmcazdfmBQt2JsJe"
    "eQoVL40u8mTOgn4ydJJ0SbsyZZquUMcp1ouJDSmPd8wbNKirO591L2aa/79CxF7f2r/gYNg3HEwu"
    "wYHGugQHnf4hDlaU4GCYCQeGqiYcbJdxECGdNuHgN7maEAfsacmxEbG5gwr7vGnBggNJsEHWOWZf"
    "DTayRNlVok/D8izWw4j27Sdcg2NMYEOzyAyhfo0aXddUY+LeKpprMoTH7jJk//WTuSyXRuo5RVjK"
    "ebIh73SQf6gMFbCGLp9yTv/JgQUWkf25Ch3OyES6yPzHSji+izIuLfbp4fVc4QmVnRcsGXbJ5nK1"
    "y7Cx1HBO++bZrz0NV+neusbz7Djcm/7ztij9j0yxKMIA6mBR5mldiUzn1bL4003psW3btoIUPPCA"
    "zBdT+cr/ORTJZ3FHPrfRbAs2HwOupkrBgf89tAc8RMR1xySYIFzDsY3AH0euuAd1VacgcunSKDiu"
    "ZKptsZIUu1U4C86cNYepRQq+XN5ad8MJJvMeu5/PSTA4RcUmANn/1WAH3qK9xCPflKe9rkaT+kOc"
    "gldQj2b1gZcK2KJRt5bH7VHi6VxjPonR9oXDsEyeuWwAE0P8Djy076UdZULLhUh74xETbWbfZeFE"
    "4p3QN62Czz+pt2JVpHdkkg9mc6A5/kcHlOR7O5jCHj5Sz2R3sxXMwbjfWT/22j2WSTZZRMgonfNo"
    "nRf3rE5prt1lpXTnKTqC46QSjjtGHhvpAIYyVDSRo+ClN1QK4ZZ/Fd+t2yRcNCTHaxIZyONhNX6X"
    "mlyaVcl/TUGSPnBJ9bRYaIB9cF+u/WR20fBANq49syBMjpDfM5yAHTKaVyvvSpSM8NIEmTH3jFQ3"
    "ZhXGPfi+0g3FPONI2ZXvNVrdW6jY4mlWMbE0MeYfvtqz/pzV51Jui91RV2Ue+c+o87V1N9gpg6i4"
    "2AK/SXvlTHQqZJmKmGeAtwnhg2DU34O9YCAPCqplDhliv4JbCFmm4sJJcEYOUxXHCY/T+oNcD4Ho"
    "8DU5UY8F1VXKyRZmkPkL8WASEPuZXK5uWE/q07dNN1MoZlO97t07KZ4i5PospJIne0alwf/tIcf/"
    "uu3q27dv2rWU6wVHSzVF4CRDzkFvEOUdrJJhkux9vxXnHiDEhTJSCFE2VxSPsFJFPuKDA4kiCNMI"
    "5HVazwPkUm35JZZp8ks69i2HrpDtWhxUP5tK/ej65v/14Wf/QOg/7Pbt215MSblH5RFA62fnm2Y7"
    "Y11KI8pdlGf9TW35d+DE1eVYx8y3tqzK3Qnf4vyqxQlS9kWcoGWwucuCjNdKNobypBt5Csym89Rb"
    "0J7VOZSX+egptFeEhLRVodZq355bMn7Q3k3/qGmj3Ua8pjt6NkHzJYoXCPOutGyNsJvxMuCf9B1g"
    "IYB+oYakdSrmr8/bPOkW/Mb8iU+VT4od/QsJuTOhlX+CiKwN8C9U8Yq1dv5A6Y7rehd/49cZ3XfD"
    "EXYpZE4maE/xmVSUtzQFRgQvDnlSXPSkBWNDDe/neCeqvdirIhSjzXW77fU80VbJpSqsZnJw4Bif"
    "NzP2JgefUr1wL77v1k9D3lCGa2YcQLwI9JUpq/jmbHiYRiUX6rM7yfLCNQImRxojZtxNRoMpaMaK"
    "ZF0yi05woEWAyU6iPOxNck3geUn/ZBfgcfTXySz5E95dVZ/MFsDlPmM/GpOZan0hFGw9HUkzVtEU"
    "+jGXg4r3ixOPoursrr3Ya1xcsC179hZx1wSm2Ov2umLLPlhb5q0n9oX73KnZs8Pv8BqLQTVYazje"
    "pFUApUh7nNdCpAjpl5LjLj02ncMvfpYybvVj7FYWx+wn0mM7k/Wa5OQOPRelRy1ahNQTLqIq/+D0"
    "+ur3K/tQc0UZw2dtfs5+QQQt/1KcxiIIQY0MaXaSQFBaJYGgG2n2IpIYmsYiY2wYGsFp6Bk/HO8d"
    "r09Dvy1GivH2S2ONK9GTQ4NYZBQ+p5p2Nxukjz10JiMKubfhlhsnZpRjpU2+4s0009xlfgeYC6Br"
    "qC52M5Fm/rFZobAFSZPCQ9EFSn8eh9wCtcVds6Dl3wCXOPlOlLwatYwx/jyRsUO3A6K+/3cN5U2N"
    "TjgZ1yiL3HWWqepuYSxiextp/H9w2Kc1s26RFIpGW3YzVr4uEn5pOY56M1weWNRfz+4B0aXx3Dgp"
    "tRX+PrDwHRpq/lrpGnXBH7iTy/zjz3M97h+lOgrr+H3K3eiTXcJuKzYYfy3tfjPaP+6v/y59KKFQ"
    "LiUPXV6QpH1WvbJ/4ZdVjAVI0VOXa2ITTo29AQtYAOUQ5wFKT7PwVywgg0JaXNMd1agCqL9VYRat"
    "IgWrf/4boZWVM1Bia63avKQvh271CdVHr1OwAHX+4Tnv0F0IQFOGKRJT8RMHrnzLBSSJ4HS9vwGu"
    "8fz7NCOPvpsJadD3XmHGFZzDfrp3v65ITK/NgkjQNIGdtjoeWosMq0juCYquTEdh8ryLFIKmFhxi"
    "EyT/vuPeFKManf5Z0r8WNpqr3ffMsu/WwLeGr5vNmb8mdyuKy504S8NJXGpL+astuLhs801c5im5"
    "uOzgzzOS141u/saUX1FcnkCxOykDtKftSBALcVkimv1MQHWv71wYmVVnxBgj525+yibCqxkrvhSj"
    "LPuC6r+hIdlBOiJkWVVYwweY7AycVZ+hLIvEF5RTJzNvuNp3zDuSZRsKIX/TbZKSqgoqditZfksJ"
    "cPOLDFRreOjmoIdJLQPUuoA/qgTwdVIBuURPYiL+erwWUbJYhDtdx1KM0bMU7Gbe1PbrpFlKNQWL"
    "29ZjT4vXNKFJczuSBwkbyb6y6rzPcMmmK4FPcioVP2lZZYzhOuvwRoLiSyQM7bnXwMoJe6dApDSK"
    "D3477UyWipITy/ZcpHu1aIH1v37351O8cOhOa38fh6Kk9PUc6HSNLzZYEaV8Fyoil+Z/AwRyVXMT"
    "zPdBPXQgNWDe3fh28i8vDWDOpn8B9bHfi6m3Ynne8ASeOz3yuIKBqqs99FtQlOI3i6VaaMgOYIqo"
    "xzgRSTfQIKaC6hV6j+OZZBuUN2wo3ipMIiOIRYZddWQld01E28DsNVnJ0+IsyxrRsuwIWTgrgcGM"
    "vXjK2Pav0IW5GNAQXGworUhY+WY3G0XOcV0Y2RS8fJOVZ+PoadFn1kSjU9s2h+d4t+ZE4BPDX/Aq"
    "SNYeqLxqDeQICZJIa4DraUkhNE6eQfIhbjw7o2/LnOM/2DL7iOSyNwtolA2KU4C7mewQvOTntvov"
    "VPzJyiRHlrpb3Iip7hXVZy6JMU5jDDTaFkW/D0uoz/3d1546mlV33W52rhCneQXipy3MZBYplKJ4"
    "E6EYDj25M9AlMELBV2CGwa/8HRsh115OBG6Vk4dCMDDb7Gvig4kgB4U8RMWre2IytYPMZsGiRYue"
    "yPd5Fb3mTphzjKhcUvqL0iW2WqhAdBNucaOmYq5u+vDhwwcpugvFruPJDg8UPra34RMZc+Qpv+Gr"
    "HLJovacZ1WqwGrQMyuyM1IgyJpRMrp6a4sgtfrL5nIR0KuJGayL3DM/k0oNbFefS0qhmm7c2a/Tw"
    "xv/8b+zw8rWUvNgmnrYFGJj8nJfySaSSfuIppU4clfW4sLZKj6A8W0+JDIOT0kgqLNnBQ9hDeca0"
    "HU/rUJ2eX7oZGxxHeeyR+4dyh8sdX2NmsdQAGRd2fBpxdP7QjcHxF0qH6LbFwtG//gxb0PbglTka"
    "uJsBl5TVqyvdazg0BmgVCdvLAVR7Dj5mBsnqPOIiKRXVe2dWuTJzbEiMZN7Undk0477UT7AH1fpi"
    "HJbbGljpdgQmObInJt+lmJ1M0EFSgiQlkBebpbewk7hYcoFI1hjuM1Y5IAhy7r+FlPvDW5rugg1m"
    "P5yC9a0CYE4rVype6Mxe8gUUrHl/FevQw1TldHWkSbYtErYjMsMRNehv9eH9EuFHpMgHoB1YZVgh"
    "FNnaGIHCDx2X+Tqz9yCd6Cps/s7okEPBxeE0RxVXhNF9N4SiqTQjHuBnr00ba/AiUNjUFOBje9fW"
    "AQCDFZfk7gbZM9XCEAkgYqOo9/EBkwPPetwa+9eqpxGv809TMrl6SrjCIe/1SiNSk/UbY1fWD8az"
    "D7GM7SdtPwDGsnfxKCkCsF9OeQ+naLfVKUzmKdiRbwrO1fiobyc/VMVOgPfgoPwzFQVr3bDNfL9M"
    "T8ZzQ3W8czfkyuCv6P5GaVugFzeVBaUSUpHU7LKeT1HvRWo/xXv1QXuj8l/KnpQlWX9mfzoH0tbI"
    "lv5dUL8yCJOIORmQNJfKAsZSDeMUR+GmuGwb5D+Gouaye6wDCG/EHDoj8bYtAAlSarPtcAWtDQiq"
    "FwYpzdJgGKtMVSau78EAb1XMogCOKFlvxO1gLunha5QRMU5bZyhXoIeVv6vRJ0gSMsJD7hlRMpEx"
    "0TARMFEvkS7O+1U07PprADqZpcDjlqwnFHtQZchTWkgNVHccyD2faB4ciOJH8Yn4dg8vw+oJFJfD"
    "J9xvimSmBao37nozvU3FjNsUU6mCREcJwvqXQEOK0jYZpogYKl9cMg+4Pz0euHIfCjrFt5P8oXzJ"
    "CX6DzRe6vdY5elgVCaQZVLF5T3jv7r4kplrUg4BK5eyKPhk+F++v8jgF4O121jSlEM5bsbH6+RHR"
    "OEYv27oOYm34tYrybL4yLUaWIbNKlSq9haGVKjmbVpjA646vXr0qhPBXr/b9uzv+Feo9g5sCO5//"
    "rtKATzXQe/4I11jpHq7MqxW2Fko9f2btdAqhFFdW3n2+xgLgoVkRyCqh8zxhYtnmQk85rBIlPNa3"
    "PC5M1aVyCcUpEHaDmxZEIckSCBSckAAj5aqLNOH23iEjnXhNMogKkq0gHC6bbOgqVxxECMppNbvp"
    "N/JXesoFj/XuF4HmDUVzmmgFWrB3zwG21EMwSmFrhHhUiUVIbA0BjrNhgWsA+rUC2MWejVyEdEtg"
    "wzRLAumC/Wtpg41+eFtuXgX2GKAme4EPqjFfB3FK1kogSaI6kObxejC8l9WkeWWZHx0varV8lYpX"
    "FF5IKnsU33RkBCexuC0CcthQ6mcB8QVo/wCq2bv3RoDfeve0Nok16HzMVA3EdbR5VdnsremvBU1I"
    "Z652+ffaXrTEC5ZXWQjIzSyCEKosBLS8ncraUOxekD6tbwSj2EGlWxZIYlJnG0A/WhSrAoiYOHIA"
    "Yqp37949zF2Mpt40dpH38gBDbXZKDsWhH3FL/vQOsl779u17xkGBWBbmHAj5AvL8AIUieEXdhKgt"
    "HJdzHjwrADAlrc2DASqV+3U65cV2A3RvBPCuQan+OaC2U5yRX7EepdvcBAnJQXST2VYxLyGYNWqd"
    "vAC8L4orkSUtl4liLFhsnAEBrwToC1meLznYRo+ijoOlEkhlcBBn8OaZM5koN1efKNGID3qsoZYB"
    "X9cMES/5BCVp2le8EM8mQ6BkCZk1cuiQgrowBLHSHtXGcAB57wV02NRrHgbuqcbZQSQwelCtaODo"
    "ahOKIV2eZ7YPoKnH2XOjeRUcNLbMhaJeTgPyIEOJDCemgkTbyHc60L6SY35WtUzhJubwVvdV1nqn"
    "AYab6nvgmLyPRCHkNFCIqi16VvpsMzLU0GrA/zuZRQbk91BW+wjQEKX5CV6fCdPLA1Ubsam0a8xH"
    "0Ewo2ykRDM6sWz7vjpGq1Rv5Z0LR40FyBL08n6FzMr2EBMioiW00GJs3yMJgOwh71DEf3pkokCtu"
    "s3hItRRlTHL4/gWo3URFgSyEzoGo47LTwOUS6eEhD7zt8wIoDiZ27qUFY4IejGMYuwgZ1Zl7FDxD"
    "k5TP3VH4SjOhm9tkciEN1SqKdzLTiZKXkBOYBnBG4aSHQAdmeQ3AqyNw3TQSYJw7ins3ZnefUgrb"
    "cB7DURLRrlRTYyTQvfcWks2mimlKmcq0fqzlczVoXpIr3NcgcDKSlJp6QpUJGsi1Qul2VPBLMxRb"
    "JP/3I2iWAzmdVJ1yIcuaDUEyJ3FFhdidXpJsDBSPdv0KubIhgZzzc8m8y0aRdR6859bV/os+GgjJ"
    "godKlay6D13xxU8yESfzLx5VsIeA/ttNKFQxhUr5fXHVoucXSMwcZhY6aMVqwwd8ag+TYmOVeQWe"
    "YlI+lQl7+AGgAT88GzRLzJwuALxC42MO4oj6WicBDJvJenA8gpYJz3f1TQUDL3tyuQDy4tnhy7za"
    "8+aZLhC1/+Bt3sb/uegrXM3bxliJt63TZIYrjBReTiQY1tFMuGE/3nJtNzgdtHyS3GJJFbBK9wDu"
    "Wikm50PRDAXtTRFEcedC7RKO2gsNv73LThhm5rPjJMg77c7YWdG5D5bI8y+a1XuPQmxibkYjLlGE"
    "pqueCTx3wiolQhEfrSJYTsKzZgByFWKtvXtlpVNv8+YapnXRpnTICDCtJGaObSbP7ltXTIzZHMGB"
    "wa2Efr41qla5rrPTjR0oN7ZPxVyslJZVY2Kt2KM8y7IHNEXPdbbzoI215gzzMR7epwenhjC3KhL1"
    "U3TpH4OTHWytBXNZ+lniDfxtC8U8z0ZbWkZAt5YwXZEcrhwFsalqrUGXVYH9gWNod/lW1+bb19ci"
    "qRoqqnC9NlF0uk9R3t65vyy4pMvmlkrLU+GoUlI3ly+xamvaluD0rE5nYmFPZApJpuKFoNWYkncf"
    "4OpF4MuNqAp6cH8QaZHtyDIWmbwmwzwdDjHsU44VZf3glLf3MW6+XjAJ8xuslAaSHmNLAL0bora/"
    "yK/A7FsQx8WVKgrucZGlCT+HjzcJLXVXBDU2NmWXE48HgJovOoBQ+rRq1YaotraWXPvCDkHpw4do"
    "lAkD5WsbatEXFiALAXBAUKGw+tnIP5UF+i/sCgcSr/Y2Ici095zjAURd9gnSGh5vxeVFjbhquNSh"
    "CUqHMLKcKRZsji5UGXdZt1bo0sm8Kl5iwvH3sAcATxGVafWDGYsDLa1MCwVwJ0v/dIvaKJU/I7F+"
    "llUUkZbrmTh86+UG8gOcPRUl4j3+ylLbb7h66Yqgtn37Wc8ALsiDtsyBTIU8fmT4ujK4AqD9X8Fd"
    "APUEqHgFOUp8WLNmvY/S7JleEV1V4Crz4fay31RMkOnrzwGQxsVGnQCQUyEB8MWNmsp0zXwTMCcA"
    "kmyoKb67OLUZtTqma/RXZCDP9K7Lpq8eBUAhKbTBTQIgx3R7CaAPpNbFdPFUHNYGanX/3cUycMXU"
    "DSFs3Ew6fe9HA+RcI9lV/r1MMn25pXCpc220fPMsWbzwe9b6+1VEF+y26RHV+LyvRY/iVXNBAzfp"
    "7kGCBkrXQuvzRxYLOhcuP4wuRFcX2laYq4c3SETh4l1p5EmWPhUrQeJludCblRLcfk7Ho6T9tdou"
    "8gz+gk//T6C2I7YNHDS1fwW19bD5/M0TSsArkCGqLKH7OV2uBT7F5p/8vwLFFuy6PJFFHuyp6eU1"
    "WKP+1J5+qxI4+09AlQPXqlcBKqMlPRRZKQsyFKgMPjevthPQNlHJ9JOCs2e95CtAxi25WlBeVXBO"
    "F4Wmy0mtbiInAzQnrqsImgUQSuIkZ4ARvngSkeiKoKARk7ltKDNBV5UcKkT+3yCIqSK6o6MFWTUr"
    "IhbmT8bnpFUUFDZbB3fP6TIVMvXB/xXQm1o905Q+NLHOjXO6d9yes3ynO4vfzhV1CBCAcBaKn1JZ"
    "AibbeRNwWA3qChXxQPDnG3D8BNz4zOEGRmz1BYzeOhpuMlxFra5sgpkLErQJpobwZQiR6/zh8jnd"
    "G1LJe3XhAdzBYOchHSGdlwmCVyoBoa01R0CfL0JhJQGVyQR/AZE1mCUgzlkCKpdrgtgEhK7wNytu"
    "QozgZgcTf//xyWj89AcRUJkQ2fl352bxxYYNzpAziw4HxZ7NMiGSuXFvi7teHsjK50V4A2p/B9cx"
    "if87AOVZDGdrZy25hKgoLvzQ4hyg9caqyWtqYmtwo+gLwJdLpniTiwsrEe25z353LhG7MdURql+7"
    "I+rTzQFkIVLAP1RAVSR4gtDMaSs+oT9quuNmKYRu37yw6iclPcXBJOr+Cl0BtfV3Ys/B3qQD94ab"
    "8OMe+g0/qHHPeXmdI3cFzdFMM85z4YSf2/LY3Uw4wYuqfw+b8IOGu6eMH1c95Co4flq0vMg9ExN+"
    "dKRz3S4ifjQljpRrWbuPkFuqJL1T3lPgKnFf3+/UYHxpUoO1a3dDkvhNVoMVydQTYAfyxpC0Nm48"
    "mU2MLN9m8CVEGQ4fzoW3CiauXcL3FuWgbQoqK/kJ0xHPTIhAi7eQa/4vsZPeLwpB+7InzwyaFk+h"
    "jaAeUHVEMRRZO0pAEfkuy3wdkLykY52F69gtBy/MPz+UeLnyyk902yUxK1VnJwH0a7JpQzUR4V2B"
    "JlhYW9c2DwA6scumcKwZU8x7owZD5ErhnZuJ2MkOU4VbcdVvjnWDFtOmLUZrYdq0ydZ8hzQ4UbJZ"
    "2v8h6KwDvj3lUx0vjV+tK3L/KHgQzYxq/yUYAumEouPIhXuAlnaq0iCZjUI/bGCrw2T1ODwUg0xt"
    "jPSxO0qCdH9ZaTqIIg1vXT53Xb212uotQeQqIyBJofhCLhU6VlQ6uYOrGZz+djwNhY5nMKSge6tK"
    "pY1DJNgjVslJnjNB7JXcFf30h5wb0BTMhNd6OCRvYkCd6WVa+QWQK3ullvEgKsJ+0gm3hLG6ebpx"
    "6JIsNGWLoJuNEY7js3so2E6yED+jWYA+alv2CNLJo9aY+aI8YFnkxaB5XOc1QFQ57voNQDNLyoyH"
    "+UCJLzRDUmD/RjxQ4kVZgN3o1IhInly1IKCRRYCQ1ft5r1YSJsnxMWqaMFajiIK7I3Va6q/TZ12i"
    "wjwUpB7cUf4FXQ4dJDn1AxH9xm5cTIUcXlxh/obGPkYMp6GhJCJGZgN8ELG9Mty93MJkLb42DYzt"
    "ea4HHij7SBDnwMrnQm4FbnEfQgPWQKFOW9S1DTbpMvm67b26AqcqWorBUYX1Hh7d6cgUgZBfBmkw"
    "G96q0H3zFREgQF76wv1TyziQOG54NSR24b0cvFCElEwXnzyP/wneDjoeoK1RLLNank2jElZztOhL"
    "Zg3SZJDQ0v0kyBAx2Vp5YBS1dA7hpjiLAlW2n1LeA4nkGC/FM4JGBGkropA4Szq+p9Wwkld07mOC"
    "jD807d69e0M0ciAiBVLCTqdQnOK/OdxfO4G2g/28Hx3+39vOk1MZk02xabtc6GEa/HU5PioZKpkU"
    "i7wpSH8Quzp/C1CXhKyZm0beHAr15n7TAspCeQ1WKE8J8tyAHKW2yTbtSN5pdj0qo+titp1Lsulh"
    "kUBZ5dr/n8f2a5G+vHbQM71G4qBvoUausX2DI4rfZIDndhZRwa1HJJxDBWRqdtVKZgCefQ9/f82B"
    "hxecWO1IuGPGSp19x0PY5pzOzGaH6zRhYxRsC0hP0dcbz34//wvZSRTgrDh+UyJksu4PjGBQQ7Z9"
    "Bpxra3UPslEiuLHyeZDdFCf4HE5QNvslA6RrB4Gq68rzVIRHDRmJKSBvPZBhcj05YMEBv53p+tC2"
    "CAhNWyMDDKOcZwDsy+DZnkQIzeBa+wV8zYCHPDsUlgGaNkS+p+iufFrkEAc7buohSwRJrMubUlGy"
    "HhzwMF/zfjqOdoIRJD2PhCVBdE3HxwANa3Ozz33cOJduNHYhIDgTOHTpYqtIhXdOCjQYWpEELkoF"
    "vpjk12gJCrfLK7bKfRcaq1hDDmbYSCBvXGZPYpHXrHBIteKL8eNogtbIs7TZsggSvDzInPICWg+E"
    "M7hZ9MUWoaZc5FdGyM4AH0pb7KR70T83FNG9zOEkWi1zE3g+3qpiSRmgUhYhvW7n5tz4iftlEBrM"
    "fcUYCpMehyxFJVQvXbuuB6hZwraUItnRk5qDRRHNWp/NG60pMRBw2QhPFUzZ41g+FO4U82rtKb+u"
    "waJjZyviuyhw3JFKtdLnDkdTLZ0HaPcmI66SY+3kPIGzQ8UCOFyRijHzxO4o/+M5WSjGb3U/5uuS"
    "De96v0hewn7j1pIB9tmoCYdote1ryHFYE6HOQLXoiMN9dYCyiA0QMs+FrD4tH1FEdSH36XlsdcKD"
    "iMtoiu01mzkP9V91gFkqFFpdG5wCaMJ6FvCOU/1XuWWnb67rSZRd2kTZD00E/fQ7wFwAM6IMb4Yj"
    "wOO7hp5IrN7us9EGzYAvSkq6xom7nkDu3wBxXFXdgi8zfbsY4dzFANqn8GXyshw4+NefJKBNzH0n"
    "kWuDft7GgGMmLZGMevkheXx/f3iELoIyGh7tQkGw/APoj5vXaW5DA7Y3DXinaZx7/g1Q+mFylB0C"
    "Tq9B8yN+cvolnRGQ+JlzeUoFDnxCanbid01C/9CS3466/owyDg1lxR4JxnvUcEiBgxlw9G9+4kR/"
    "RMWbOcfM3FP52Sctx37SBzViOcDt3rcSWWGuOZDTlCIZ251Q/Q7IocTnCor62hphVQ6F22eQVGNq"
    "2PbPf0uiDowFrSMNZTX71o3Fy6INr/pgDzQ8dPgD6stf3VGG7Mgh6wb9uOc5fGbfwKe/AZK46Hwq"
    "cvsKOdvVPyBb89IHhzzBAPo8ynqiwRhRzhbJtSbaZKtor3aY3Y1bRGiDbUIrfQmVaoO3KgtCrBW/"
    "AzSmkWeje/MQHzPnsxG+HhJGkEPZf6myC0xesDNF/7YLDo6n/wz1MsA4muTz4Qx4zuXzmwxuoHH5"
    "fI/L5w8ZoG79L/K5RQb4n9ZD+nAu+a3LKb7TBekg77/TsEOlv5T4ma/5anjf71nybLaBmxUGFJfF"
    "8KWh5yUUfg05V9YS4hI9GyuE0Gj14aMmcRnuar6FhCRakoZCLi7tjuogZ7oQyZYVFCbh/E1M06JV"
    "sTifckwdyr5MXrTgRVLdHJ4Va4uTGDD3V8ccYmDGxCz9+1MSnP2Xyj9mfyBWyjxbnYzcXP9USCuL"
    "In02c1q2vjLK/+wtPxL6OycTvjbhs1Ud1+Hk/Fpt7lRLhnL6UCMtRPwRQsmCLsESGGN58ti6qshv"
    "lJO1TrEsKHWy7hHnQ/jQguQ4xztCALs5VtTDnooef7mOMQ2Ifffew8cGJKC5dG2DndkcbpCaqyKT"
    "abuHoOQ9FiI3lQ23/x5SqsGfMUcdeuOvQN3IcgX55Yt5hlFCSLE9D/K8n3LqMRMq2yf5BVVQBSd7"
    "d+RJk14ArRURVB9zHt5T3qjYsZSa1n87q2HSVKCyOFRlgUEiFdiK+ttUHoIpxjPWyJexTEp+QEWC"
    "0UjeB5I3tSWfqhPAVGZdBBNU6TCHvJq76BUZy7BDcE+RaMzWOe0mE7EvaDvDkz0wMp70sHUhhMGM"
    "Tnjg+wyhz2v0QLcPeJknegpPuXfAF+yUzpXGUzZEhz3ql5yAoxmUlFzHIhhS3avmwWnUMwVwPwSi"
    "HcSdoOU9R/En84MP0TtZ5a31cPEjpHlQlvqzQ91CeKj6DfLRWhxtgFHzk19b8FpVovzBtBwY+iOJ"
    "BVDiJlbFRoBUtXQx1W9YpMKG+cD/WMMqSI0Wtf2eyNTyVjbnSmLFI0u8jqvwWSmvRpFLC9k6U20h"
    "q9xBRD+riNLB5Nb1ZSOiHyvr4THSCB9pZPVzIYXYulwiFFKlneM7oN3bmMU9gJlMLhSjddWHTEbI"
    "UW6n16F04tgcctvRgVTPpiqUIDQqLAw8AFMD+OZnP/G/7lHuM3cYrwFf7jGWO6ok2g0OfH00Xwzm"
    "LA8qW9SjbAPN9vo4R6HAAwPmkw6MazfQNhG6/Bc/c7d4VqzDLc0/IJcqgmargS9vtA8UlURDwGDO"
    "vQpeRVdOJJyUMRBOSbAORp4D3wfSRCRQNd9SpQ6vNqWUFI/ko3HN6m3TkDn0ByozF8bGHZxMs+45"
    "36enNWtQ9yNZzqkwK+3hdfS4tO3Loa6o1RFZfM5iexVAvX/3XxnzpZJq8DB7D3TbXPRSq7rHVrQ4"
    "Nr8DBA2GmzXgQivYZyttLY/eajUHVpMCb7v8WMdQnl5MCma+VPgTmQ/6fB0U/sauhEHc8+Li57Oo"
    "lmo4y0WryLzGVhjUAs5XVw4wWZctauzIyt3xGK7sQC7Mfsw2ch5STGzJWo8VdGaeL9OgxWhI7Eo2"
    "bF9y/uB9WWLpVxN9C9G5rsZzpj22LmWqXEiaL5a9dc2ijNA6Eoi2g0jvvFJYuSOxm6HQqTMO1M1p"
    "9QNUdksGQ3gqz7VWPIPSPGGrlZD5pi0TFIvEkhqPGUNJqLotasrsc6Oy7yBJ3s+rjrxRcbzkwVYT"
    "q00G16FQvTsvDq2o++PBh/LpL7naGnBpb7NnWZUqy8Ge36Q+pyTjFeFyb6wujRlCrl7l7KdmHaFV"
    "fWQXy+A0T1ZGs8JbX5Et0lCueF5Kmk+JKlRxW95yxDZvUfVsTmGlglZi4W2M+zxRPtgZQpUTRW0H"
    "ypiXhix+seUxgC8VWacl5RWXIS4T3YRIqFYb1GW8MuAmSueGkGfLGmtBW5Mp4iF8PxVfoutTLqAY"
    "NOcHZ3GHyEz+MzRIIUgeSBtIGEQVRGQ43n5Z0A5llMHfE0WxL3avgEwjD0jim1K+410L5NI5mKeh"
    "aAGIIxQRw7zj6zjnQ2gTNDyeAv1mM/d8DTceslkFH6vTXjeQgtSnfERpDDacR3Zq8eiYGwWe0Lw3"
    "UnkmFHHOojrudnwufWELM+tTgJj2pbQs+/mgiNuuyqrLHELPGrccbJslgT6M9S9Sh3qy5TkTMvHt"
    "pZU8oFve18u0gZL390DlkSN/h7MjR9ZfIFP0nnIDBmyA4wMG1PjrxUQVK3l53IgZ5V3AWKktKpjx"
    "MIjZIHtazp43b95ctwr8Kd2svGmv6rJW034tjc5H9wpGEJvEjH/WVWxoJpb6DRYzjZZ6a7GRkdj7"
    "eZf4ux72eWLp4FRZi4dJvGa3ncgVsLNixXVZrdi8cqlcO1qtg2l/PaeJv6/lf6KhCVkh8NyOKd9B"
    "6uKPlEvCXk0hDRFNccP6HrELQbIYiOy0YulUAFtk8NpxZaYB2LQBOHAa+bpQiVofOpeNoADzVoAM"
    "DY9NWqxFdRMlb7LkJusRu7k+tE9bnU9kD7FhZKfhOQwO59K55jCWKa9n/bdnhVKZBXOUijdiQvLl"
    "7EAeUsbUPRuGoO1VJYFnaB3ZbUibjFbkryo1+YXRqCWcXRSsml5sRFYlTmyG1DUTkurxnYAgurw4"
    "x1ZUKhVVRWkgJDaUZICNFRvgN6Vdfk37oY329vZ+AcWi3G2GsUiUcqwEo9jR0JkS6VeJyFTjJm/N"
    "MdVeonWbrxosoVJHvRjNnBNB+zqPr3iqdkkNhoixclWTTUlmZLaPXB+AsyLiXhNAhmoX5V7hkNU7"
    "QHq9zknkDONQXymtaum98KD2tzLDietph49syA8TTzxgiqOxHdyGdeN/6sqnkohNilLHefAKx+ld"
    "kYpbNjFTrdGdgLdniOAfAyQVgwEnfPDc3swuCF4zm6aN0MBbDMWKRgDTmOUTch6CQXqfDkZUmfbH"
    "M8HwYah4UDlT1ofV91ko9ELpJDmEpLgGcSL6gNJ8DP+yITlYOYtUVCtsfBZKs1Cf2xa7QG3xIw+e"
    "47FSaSM6C8qT5OQeBIhLAdo3WbE0wqgPkSsxHTn7jBeT2iVJDPbEnE2bNm01Cgv5ZzDyOO9LUbbW"
    "Sv6DQhcgVDaSRoklz8mkBhxyBWGNgSyRSis/btuawTSDHbNMCayXcL1Bh1iUuIpCCmNupVFeg1eD"
    "p2QRiTbkzmusFbNJho8L1uShx9QTUPugv6mz70ZOHGI038LmE+ScvGEki67CKTUYo5ZyW1rhLsei"
    "ykzZsXYQoqdLJt83orR9CoRPXKWD4134I3ZCenegfSY2QYZTNjzrPr4AWaNXHmcnnHWP6Y+5J8mY"
    "yxex0FpxHWIdRfC8iAS49c49NdCMGOjw4ElJBS+aFs70mYsBB7ZsT2eWgs7J6SfDS7Ra3xl1FAXQ"
    "tgJEKLrAXGZRwRRG48K/zDUS9IMyUKE5nwLDJqtmyfDpB6pPpBAWvlGS9pMG6pwA8W1EAdkN8diN"
    "rHELaq72YgLXqXxWUmtd0rN5i6k1dzAVlbbiVSJlFfIqTLdisUeYXRGITcJqv4B8vkJZtUAN18mb"
    "szwFUgXGmn6A9P60HR9ccaM/tZjL8wsOl021TQ299/gQftbRPErLUA/C0ZFBYHBdmP9cSYkiXjLn"
    "8EbsQWD5HBI9heEvb893D+QF3PU6eJiS1/IK7rem8CLOhqm2UDnlRZ4xIYBUhvkD7fEZQ5ffomzG"
    "qsKuzNZaZT5P6qBI3818stXvA1n83rrQzUPaMrbgNTsS0hFqjNVaM//XbGNMR6g5SGfBHkWyne8r"
    "w3BH3bnNWjiZtYO9f6voGxg/fd2zXbbMG6ZytTFgkQ1TbIDCK94bXsFOQlufLQ/jXxwWW+GWWujT"
    "p2SFCBTI5PgR9HIxW1Mo3AB3ZVFzsrJkpDII8wzoyZ5yDdoPUs3YJPhI23GCNjU1k7w7Z40st3ag"
    "psspZWNjswDSze8KpedWAB05A49BcWPiYPMkONKz7wlUrEm0UMbBCPOSYH+7LvvB2CzJ9KwkuLNk"
    "6SPQd+LXKBPgEAdK5cL2JIh99ISKJyJ5CYw/8bxVt8W755GFVYrXjRjQwrgOBbsm3kZWQX8eLXWb"
    "GLjaQpS1VmhdS6wfE/rYBFUWSZ8F11eyGHjmzFoZYBebbAQtev7ZqLuHhWpBfVXsbGfhqZRl04y2"
    "9kwemvonBPy9dyaAoT3vrU0BbOYAavsXAtgG4QLYCR8E4AeXCVB1K6IUVHE2Oiuf3GloRa/2lTaJ"
    "v04yYo4kwSWS9B2SxJ/AwReuadKkSWNL+fteSRB89uzZM7W+fW86F2VjOxMplwDIz20h37chCR6g"
    "YN2Ez50jX286F2VlZWV6ydf9kATLypQp48b+fF0kTDaFV7ou2j2f5E5pvu5JOmnGbkLB7l8uAKy0"
    "LuZ0se/RjpZ8nUjJUr7ZeXl57/lU/PwkAdIq81Ax2w0hLAqCXFmVZFRrE4ygD9dCUk304F5rIO1a"
    "+e92hBzv48UV1ESB1PmQ9u+As8OGDTtJgFw+lQQJgYGB8f/+YhmI4imnaRA3nrC14T/9RKLWmCSQ"
    "+ospexLP5tB+ZiEgb3Gw82+BXpsJldfh1XQqoqxRBJs9voKOagwbsNrX9FD4hNOe+KOa433wl0ZL"
    "lrjQBNTOhvvIVXPKxkF4KZySpcGQXpXmpoACf4I814vZMgJPcSfB7ykQ68rnr1kRPLXkE9nfCEfE"
    "TM7Ww7DxPk3kKV7xX55XKrGZ+H65THrLxy/hYtxq3iLrJApIcWlULYlbpC65AgxVon3EwQIYWVVb"
    "wMF1+vgrsIqDow8AhFcRYDk1DKwoQNb3V4UJFJUd1SLFjo9lDYby4xdTqPtHn5ZJQPvKojTGN00y"
    "ATkeAihGtc6BlYXQnwOjZ8GXpxxQPqeMND29lloGUPbCFv4SM742yqLL4u1jqFDW8T6XCUMoG69d"
    "Oe4xGBuZ55MzZ5MHS5ryzAy7D/7teeKdXYFn7XjRAhLAk0q8W4oE1PvREOSi+JlS5dMl0GE3P6Px"
    "MuK9DtIvCyvGsqzJSlrYz9MkiXTTEbg5YdYLgAZJFIV01sEcDlSTYFISvD10JgP0lcXF8e0pOtqO"
    "1hYiIEddS4BI06ayxNlLfudDc3pkGtoV0Cwf9wSHZlFA1hUObVEzwdmP4KY8tBvwSB7aLXgghqb8"
    "AjvF0EbSNTg07ReghalsRJgecHB8UFYeNi80B2los+oy09DihiJwacK8EIhSch5FWdGbAx0BeiTB"
    "59uBeki3FheHlceLt9X9HZJtGV2D9tQqDuCsFZWPJM62iSLtUHn8dm6TsUE8u/TOjZllw4sJy4rh"
    "PKtLlZis99ZFDOcvca4Iz3WnNZKfV5PWtRtyJpMijVbujpQLA6g6CYqaklFucCudCobwNL7ptPul"
    "VJAS1gnrwJXb1D3lP9k10VSOlzru0KFPkHno0Fou/UIF3v87YDPPB8z0IQu5s88AHVdux+Dh/wqI"
    "4WQQTFV+cTUU3SSY0gUJH8VbUjnWNlgNOeIP/ZrxxYZdfHjldnOfUb8C38bqKRz3MAK6MWWM0I89"
    "p6jwJMi3YnMhXcX8yZupKEF7Ry1fzRgM24ZBkS0XB/EXxNqR6pQRFO7AO3TUxOL6uRI3exv7yEsp"
    "GvsMHQXFIiZyHi54kYvhWpkqd5ZZ6mCgIg68rA3QH13YFY1FjVRVdhouoiB5MxYKlGizf36fe026"
    "BC+oDMcIRwfgYT/9nUwkKCu0u39FXsyBDHMqamnPCRrNuM76PCfWxmcejXOcT48merIAh1JUcw0Y"
    "fiibSfV8lmEQcQuSyEFqqhcr5UQdjfDoXJEwCrkDcwlyc+G5isd6x4wgR7NcDmHgNGi9TgDt+e8U"
    "A4/6+fCikI4+gydAPnorzlkwWxVG1UQ7IdqC9UI7ta6eb2R1Dx7fgRc0J42MImcgCqPkav4mJX95"
    "FWm7xZ+hqkaJ6sk9xJ/s8vn5R9PyxwqkzG6CcDpcEyCBJJDZA9A0FwsJgf+pl+FymVfDIgij2Swd"
    "C3m1UA8oppnKtSfIQK5qz+HD++1sCa6Ax3bNFXi04Dni/+1xz3Zb/pyKihFjx442n/fkB7msSixo"
    "+n+NXWlMVFcUvjPAMIAMMCxiwdoqhEWstlgR0ZQotkn9oRUjyrhBdKo1VWtF22qs1ESjqS0YlSAK"
    "2IoWilqsiCwuLOIQqQIFpYBKAK3syCazvHd6zn2DS6jRl5m5ZzIv8969757vnv3K75vTHWN4Xjtt"
    "Hv5Y4sQUcwDhh2DeSrLMXKdvhVSiginb+xzMNoEvzcb3O5Kj/TxIyXtus12WJCcnf0rxXPs8glOo"
    "sNjuN/8IP3QT9lF16n2BUVFRE83lmR3KIM3C9vr9PV0pyplK5hw8vX/4CHuBZBN8lMwiDwoVzDKO"
    "R42pHZjT/lsthctlyH81GQOwSr554ygWj5K9POx4eT9UWFZB3cFsqIgia9BpqFgOXdsTRKhQJAxB"
    "YwIZBxVvkXhrlZQq6TmqYRn5RWJTQVPOZCKgT4AeFySOWU7oha9VPDIuF1JUFKWBg5SmogmNOvMu"
    "JAz59WCaZGsw7uoFc2VpOb+YfOuV5mtaOa/T3YTPk7kJsAzFLlEdDkYbnG8uOLP08uGciRkstA6X"
    "wjJoO9UGJTLm+Ec/GE87Syldz7K72P4T7w17wzXPCcejDeVriSjA2UgWFD+yoiDzahaB0YrJnoBm"
    "KejxKXSCZhrxBWKKRtEAnRc76MTAWjCm3eZ5P25SIKZsY/793xZwJmg81WNayJxMCDJLoAF1JuOx"
    "Y5kgumAvruJxxdOmW3Rl9iGB5Dwo3lBJqOO2vRqM6ZKnd8zwfmbWLtjZoErKiZS1Q8O5QHKyYAd/"
    "qgbQ3Rh3AQHFoPdDpU2UdLdXNxPFAW7rSr5XFp2oC6N6BD2Iq9oA6gzKFlqp172gDTd3n36KIG+O"
    "lpUAkJ1Cy1yTa3U4aGvUu39wYEojzLJrhfw1Z6Dbhk2ndIRmitqSvxM6js+cE97D82TeCGJdxoPc"
    "uUSYBkUYmIzEBXvvfvhexbPjLsIZ6eQMOD+SsDVQuZpUSHdt6/BxF8QAMsfbFJe6qwH8/u9tbxBw"
    "LbjbuYI822vNMUi/6+ZS7IT2NR/OepibOgQt9ofKk7ywU8mOw13wHknI9uqyOBEPT2YQkUktZxBe"
    "aJ/6CydlnFhvIHmcTl4uwjpma0B0ijGZplglpRAjBbzubWsQvG2Ki+YX1x9WbKm4GUV2TKEboE54"
    "AsLHauI3hONQi2sQpwa+R85TGdsJefglgIVCLxmqLr/6C46ZNwsSW8mq96dN8fWQsw+yQ+ga+gGc"
    "OuORyLAL0MMXai4ZFcIRNZf5siFpJGFvEINIBD7I5Fvym/K+ktHTE6tFRFd3EcKR60zOi0BvzWiN"
    "1tB9yg0Q4UsC4wxaqW9Bc2ILMYk6CxHjnONzxLAuKgnLbcqbSuNoRAzqG4PEccKgrSp+9VxIlQDr"
    "PJxSUfAsYlDsMwxCIq4HuldxUOP/+AzdlFV3fMzV247fK9Me0VFYLSIFyiL+JIov5UghWDN5L2gi"
    "gTYVagNNEKGSPyFFPXRdbCfmmlIDhoQuDj2uypcxiB+X787B4Q1OLp2u5rHsi7ApDw8dhU24ZJ0O"
    "HdHggPL19t2TtXVpfsyuDS7lQLfHLDC6sVkRTvaoMuWsH43r995agDZfOy9H5vUI9kRC+9YYPUTK"
    "tuGdtX9H4pIrh0vP1HipmMDT5018DQi6G+MvcYyZ9PJvw42vZC+Tt0PfXVwHA0v7Yb5baSnqIIm6"
    "SG+aTqwCYkcSXtwBXA2x1npYzzwFiMXBNV7F2RvLPG6KxvQcbmxSc4PWNh1lVKfoZi+ERjlecsjF"
    "6iHMYXvI87IbfrVoprXmbdNAOLdKoWTWLnmxUWYZ4FPFopY7lD/XrWRsb6Ezcy/OXoArnO0ARLHV"
    "CCeDJpcFAFmoyKxmWbAsVSgfdO4TRrMoyOwsWQmJJES7mgTY5KgXePh1EYielFDiy40CBVT97jZj"
    "i3XpCuZfUmKnugcHbKvJqR1kEEvgOqHNtwBd3LSIRAfJyzOMYi0UWzKnRvjZ/V88+SCUKNgcvTBx"
    "s46MDft1Cz+BVgXzMJrGy/5BJN5FYswGVPIfEvqpesVvoErGhX1Bqu/qL0KHtBT9bY6xnSAYx5oL"
    "PJjzdvNr+G4N7/MN0XSTPhocHDRKBjGPJsjDG1VVQhWKOop8eIjCkuwX6PtAioBuKSgoWGOW2ige"
    "2ycGB3nxUyhido8h3pfN5BmgK7kyf4C8e/OGqDBqAdzGldi7hfvDdvJ858XchBoIj/BmLSqhGNXm"
    "KXU8tE4ZHCqL/swa6t/8ZSXUMnf1sh1TeXUQE97T2B3ioCfPNNFwm8pOnq2aySuJ0kaP7CwuyQRz"
    "IaQBpnBhHB+q7C9kt9kXoNUe/+cx3vm0UK6fRZ85GhEQHWwneZhWKH4MmR+Xc9jhP3EA0Cg="
)
