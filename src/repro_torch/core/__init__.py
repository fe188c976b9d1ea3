"""Host build, device build and serving of the port's DISLAND index.

Exactness rests on the same property as the reference: integer edge
weights keep every float32 (min,+) sum below 2**24, so every table and
every served distance is bit-for-bit equal to the reference's.
"""
