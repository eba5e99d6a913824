"""Disjoint-set with path compression and union-by-size.

Reference parity: yomitoku/utils/union_find.py.

The port's copy of ``yomitoku_tpu/utils/union_find.py``, line for line.
"""


class UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        # Path compression.
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, x, y):
        rx, ry = self.find(x), self.find(y)
        if rx == ry:
            return False
        if self.size[rx] < self.size[ry]:
            rx, ry = ry, rx
        self.parent[ry] = rx
        self.size[rx] += self.size[ry]
        return True

    def same(self, x, y):
        return self.find(x) == self.find(y)

    def group_size(self, x):
        return self.size[self.find(x)]

    def groups(self):
        res = {}
        for i in range(len(self.parent)):
            res.setdefault(self.find(i), []).append(i)
        return list(res.values())

    def group_id(self):
        res = [-1] * len(self.parent)
        gid = 0
        for i in range(len(self.parent)):
            r = self.find(i)
            if res[r] == -1:
                res[r] = gid
                gid += 1
            res[i] = res[r]
        return res
