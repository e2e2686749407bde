// tsn_chem.cpp — native SMILES -> (RDKit-exact Morgan fingerprint,
// canonical SMILES) pipeline.
//
// C++ port of gpusimilarity_jax/utils/smiles.py + rdmorgan.py (this repo's
// own Python implementation; the reference delegates the same job to RDKit's
// C++ via gpusim_utils.py:55-66). Semantics must match the Python modules
// BYTE-FOR-BYTE: tests compare both over the reference fixture corpus and
// fuzz inputs. The Python modules are the specification; read them first.
//
// Built into libjaxsim_native.so next to jaxsim_native.cpp.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <set>
#include <string>
#include <vector>

namespace {

// ----------------------------------------------------------------- tables

struct ElemInfo {
    const char* sym;
    int z;
};

// _ATOMIC_NUMBERS from smiles.py
const ElemInfo kElements[] = {
    {"H", 1},   {"He", 2},  {"Li", 3},  {"Be", 4},  {"B", 5},   {"C", 6},
    {"N", 7},   {"O", 8},   {"F", 9},   {"Ne", 10}, {"Na", 11}, {"Mg", 12},
    {"Al", 13}, {"Si", 14}, {"P", 15},  {"S", 16},  {"Cl", 17}, {"Ar", 18},
    {"K", 19},  {"Ca", 20}, {"Sc", 21}, {"Ti", 22}, {"V", 23},  {"Cr", 24},
    {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28}, {"Cu", 29}, {"Zn", 30},
    {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34}, {"Br", 35}, {"Kr", 36},
    {"Rb", 37}, {"Sr", 38}, {"Y", 39},  {"Zr", 40}, {"Nb", 41}, {"Mo", 42},
    {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47}, {"Cd", 48},
    {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"I", 53},  {"Xe", 54},
    {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Pt", 78}, {"Au", 79}, {"Hg", 80},
    {"Tl", 81}, {"Pb", 82}, {"Bi", 83}, {"*", 0},
};

int atomic_number(const std::string& sym) {
    for (const auto& e : kElements)
        if (sym == e.sym) return e.z;
    return 0;
}

bool known_element(const std::string& sym) {
    for (const auto& e : kElements)
        if (sym == e.sym) return true;
    return false;
}

// _DEFAULT_VALENCES; empty vector = unknown
std::vector<int> default_valences(const std::string& sym) {
    if (sym == "B") return {3};
    if (sym == "C") return {4};
    if (sym == "N") return {3, 5};
    if (sym == "O") return {2};
    if (sym == "P") return {3, 5};
    if (sym == "S") return {2, 4, 6};
    if (sym == "F" || sym == "Cl" || sym == "Br" || sym == "I") return {1};
    return {};
}

bool organic_subset(const std::string& sym) {
    return sym == "B" || sym == "C" || sym == "N" || sym == "O" ||
           sym == "P" || sym == "S" || sym == "F" || sym == "Cl" ||
           sym == "Br" || sym == "I" || sym == "*";
}

bool aromatic_symbol_ok(const std::string& lower) {
    // _AROMATIC_SYMBOLS
    return lower == "b" || lower == "c" || lower == "n" || lower == "o" ||
           lower == "p" || lower == "s" || lower == "se" || lower == "as" ||
           lower == "te";
}

bool early_element(const std::string& sym) {
    return sym == "B" || sym == "Al";
}

bool pi_element(const std::string& sym) {
    return sym == "C" || sym == "N" || sym == "O" || sym == "S" ||
           sym == "P" || sym == "Se" || sym == "Te" || sym == "As";
}

// rdmorgan.py mass tables (identical values)
double atomic_weight(int z) {
    static const double w[] = {
        0,      1.008,  4.0026, 6.94,   9.0122, 10.811, 12.011, 14.007,
        15.999, 18.998, 20.180, 22.990, 24.305, 26.982, 28.086, 30.974,
        32.067, 35.453, 39.948, 39.098, 40.078, 44.956, 47.867, 50.942,
        51.996, 54.938, 55.845, 58.933, 58.693, 63.546, 65.38,  69.723,
        72.630, 74.922, 78.971, 79.904, 83.798, 85.468, 87.62,  88.906,
        91.224, 92.906, 95.95,  97.907, 101.07, 102.906, 106.42, 107.868,
        112.414, 114.818, 118.71, 121.760, 127.60, 126.904, 131.293,
        132.905, 137.327, 138.905, 140.116, 140.908, 144.242, 144.913,
        150.36, 151.964, 157.25, 158.925, 162.500, 164.930, 167.259,
        168.934, 173.045, 174.967, 178.486, 180.948, 183.84, 186.207,
        190.23, 192.217, 195.084, 196.967, 200.592, 204.383, 207.2,
        208.980, 208.982, 209.987, 222.018, 223.020, 226.025, 227.028,
        232.038, 231.036, 238.029, 237.048, 244.064, 243.061, 247.070,
    };
    if (z >= 1 && z <= 96) return w[z];
    return 0.0;
}

double isotope_mass(int z, int iso, bool* found) {
    struct Iso { int z, a; double m; };
    static const Iso table[] = {
        {1, 1, 1.00783},   {1, 2, 2.01410},   {1, 3, 3.01605},
        {5, 10, 10.01294}, {5, 11, 11.00931},
        {6, 11, 11.01143}, {6, 12, 12.0},     {6, 13, 13.00335},
        {6, 14, 14.00324},
        {7, 13, 13.00574}, {7, 14, 14.00307}, {7, 15, 15.00011},
        {8, 15, 15.00307}, {8, 16, 15.99491}, {8, 17, 16.99913},
        {8, 18, 17.99916},
        {9, 18, 18.00094}, {9, 19, 18.99840},
        {15, 31, 30.97376}, {15, 32, 31.97391}, {15, 33, 32.97173},
        {16, 32, 31.97207}, {16, 33, 32.97146}, {16, 34, 33.96787},
        {16, 35, 34.96903}, {16, 36, 35.96708},
        {17, 35, 34.96885}, {17, 37, 36.96590},
        {27, 57, 56.93629}, {27, 60, 59.93382},
        {29, 64, 63.92976},
        {31, 67, 66.92820}, {31, 68, 67.92798},
        {35, 76, 75.92454}, {35, 79, 78.91834}, {35, 81, 80.91629},
        {39, 90, 89.90714},
        {40, 89, 88.90888},
        {43, 99, 98.90625},
        {49, 111, 110.90511},
        {53, 123, 122.90559}, {53, 124, 123.90621}, {53, 125, 124.90463},
        {53, 127, 126.90447}, {53, 131, 130.90613},
        {71, 177, 176.94363},
        {82, 212, 211.99190},
        {85, 211, 210.98750},
        {88, 223, 223.01850},
        {89, 225, 225.02323},
    };
    for (const auto& t : table)
        if (t.z == z && t.a == iso) { *found = true; return t.m; }
    *found = false;
    return 0.0;
}

// ------------------------------------------------------------ molecule

struct Atom {
    std::string symbol;   // capitalized
    bool aromatic = false;
    int charge = 0;
    int isotope = 0;
    int explicit_hs = -1;  // -1 = None (derive implicit)
    int implicit_hs = 0;
    int merged_hs = 0;
    bool in_ring = false;
    bool chiral = false;  // parsed, not interpreted (blocks [H@] merging)

    int total_hs() const {
        return (explicit_hs >= 0 ? explicit_hs : implicit_hs) + merged_hs;
    }
};

struct Bond {
    int a1, a2;
    int order = 1;
    bool aromatic = false;
    char direction = 0;  // '/' or '\\'
    bool in_ring = false;

    int other(int idx) const { return idx == a1 ? a2 : a1; }
    // 2x the Python order_value (1.5 aromatic), kept integral
    int order2() const { return aromatic ? 3 : 2 * order; }
};

struct Mol {
    std::vector<Atom> atoms;
    std::vector<Bond> bonds;
    std::vector<std::vector<int>> nbrs;  // atom -> bond indices, bond order

    void build_neighbors() {
        nbrs.assign(atoms.size(), {});
        for (size_t bi = 0; bi < bonds.size(); ++bi) {
            nbrs[bonds[bi].a1].push_back((int)bi);
            nbrs[bonds[bi].a2].push_back((int)bi);
        }
    }
    int degree(int i) const { return (int)nbrs[i].size(); }
};

struct ParseError {
    std::string msg;
};

// --------------------------------------------------------------- parser

struct BracketAtom {
    Atom atom;
    size_t next;
};

bool is_digit(char c) { return c >= '0' && c <= '9'; }
bool is_upper(char c) { return c >= 'A' && c <= 'Z'; }
bool is_lower(char c) { return c >= 'a' && c <= 'z'; }

BracketAtom parse_bracket(const std::string& s, size_t pos) {
    size_t end = s.find(']', pos);
    if (end == std::string::npos) throw ParseError{"unterminated bracket atom"};
    std::string body = s.substr(pos, end - pos);
    size_t i = 0, n = body.size();
    Atom a;
    int isotope = 0;
    while (i < n && is_digit(body[i])) {
        isotope = isotope * 10 + (body[i] - '0');
        if (isotope > 9999) throw ParseError{"isotope out of range"};
        ++i;
    }
    a.isotope = isotope;
    if (i >= n) throw ParseError{"bracket atom missing element"};
    // element (two-letter aromatic, two-letter, one upper, lowercase arom)
    auto lower2 = (i + 1 < n)
        ? std::string{(char)std::tolower(body[i]), (char)std::tolower(body[i + 1])}
        : std::string{};
    if (i + 1 < n && is_lower(body[i]) && is_lower(body[i + 1]) &&
        aromatic_symbol_ok(lower2)) {
        a.symbol = std::string{(char)std::toupper(body[i]), body[i + 1]};
        a.aromatic = true;
        i += 2;
    } else if (i + 1 < n && is_upper(body[i]) && is_lower(body[i + 1]) &&
               known_element(body.substr(i, 2))) {
        a.symbol = body.substr(i, 2);
        i += 2;
    } else if (is_upper(body[i]) || body[i] == '*') {
        a.symbol = body.substr(i, 1);
        i += 1;
    } else if (is_lower(body[i]) && std::strchr("bcnops", body[i])) {
        a.symbol = std::string{(char)std::toupper(body[i])};
        a.aromatic = true;
        i += 1;
    } else {
        throw ParseError{"bad element in bracket atom"};
    }
    if (i < n && body[i] == '@') {  // chirality: parsed, not interpreted
        a.chiral = true;
        ++i;
        if (i < n && body[i] == '@') ++i;
    }
    int hs = 0;
    bool explicit_h = false;
    if (i < n && body[i] == 'H') {
        explicit_h = true;
        hs = 1;
        ++i;
        if (i < n && is_digit(body[i])) {
            hs = body[i] - '0';
            ++i;
        }
    }
    int charge = 0;
    while (i < n && (body[i] == '+' || body[i] == '-')) {
        int sign = body[i] == '+' ? 1 : -1;
        ++i;
        if (i < n && is_digit(body[i])) {
            int mag = 0;
            while (i < n && is_digit(body[i])) {
                mag = mag * 10 + (body[i] - '0');
                if (mag > 99) throw ParseError{"charge out of range"};
                ++i;
            }
            charge += sign * mag;
        } else {
            charge += sign;
        }
    }
    if (i < n && body[i] == ':') {
        ++i;
        while (i < n && is_digit(body[i])) ++i;
    }
    if (i != n) throw ParseError{"trailing junk in bracket atom"};
    a.explicit_hs = explicit_h ? hs : 0;
    a.charge = charge;
    return {a, end + 1};
}

void add_bond(Mol& mol, int a1, int a2, int order /* -2 = unspecified */,
              char dir) {
    bool aromatic = false;
    if (order == -1) {  // ':'
        aromatic = true;
        order = 1;
    }
    if (order == -2) {
        if (mol.atoms[a1].aromatic && mol.atoms[a2].aromatic) {
            aromatic = true;
            order = 1;
        } else {
            order = 1;
        }
    }
    Bond b;
    b.a1 = a1;
    b.a2 = a2;
    b.order = order;
    b.aromatic = aromatic;
    b.direction = dir;
    mol.bonds.push_back(b);
}

void merge_explicit_hydrogens(Mol& mol) {
    mol.build_neighbors();
    std::set<int> drop;
    for (size_t i = 0; i < mol.atoms.size(); ++i) {
        Atom& a = mol.atoms[i];
        if (a.symbol != "H" || a.isotope || a.charge || a.chiral ||
            (a.explicit_hs > 0) || mol.nbrs[i].size() != 1)
            continue;
        const Bond& b = mol.bonds[mol.nbrs[i][0]];
        if (b.order != 1 || b.aromatic) continue;
        int o = b.other((int)i);
        if (mol.atoms[o].symbol == "H") continue;
        drop.insert((int)i);
        mol.atoms[o].merged_hs += 1;
    }
    if (drop.empty()) return;
    std::vector<int> remap(mol.atoms.size(), -1);
    std::vector<Atom> atoms;
    for (size_t i = 0; i < mol.atoms.size(); ++i) {
        if (!drop.count((int)i)) {
            remap[i] = (int)atoms.size();
            atoms.push_back(mol.atoms[i]);
        }
    }
    std::vector<Bond> bonds;
    for (auto& b : mol.bonds) {
        if (drop.count(b.a1) || drop.count(b.a2)) continue;
        b.a1 = remap[b.a1];
        b.a2 = remap[b.a2];
        bonds.push_back(b);
    }
    mol.atoms.swap(atoms);
    mol.bonds.swap(bonds);
    mol.build_neighbors();
}

// _mark_rings: iterative Tarjan bridge detection
void mark_rings(Mol& mol) {
    int n = (int)mol.atoms.size();
    if (n == 0) return;
    std::vector<int> disc(n, -1), low(n, 0);
    std::vector<char> is_bridge(mol.bonds.size(), 0);
    int timer = 0;
    struct Frame { int v, parent_bond; size_t it; };
    for (int root = 0; root < n; ++root) {
        if (disc[root] != -1) continue;
        std::vector<Frame> stack{{root, -1, 0}};
        disc[root] = low[root] = timer++;
        while (!stack.empty()) {
            Frame& f = stack.back();
            bool advanced = false;
            while (f.it < mol.nbrs[f.v].size()) {
                int bi = mol.nbrs[f.v][f.it++];
                if (bi == f.parent_bond) continue;
                int u = mol.bonds[bi].other(f.v);
                if (disc[u] == -1) {
                    disc[u] = low[u] = timer++;
                    stack.push_back({u, bi, 0});
                    advanced = true;
                    break;
                }
                low[f.v] = std::min(low[f.v], disc[u]);
            }
            if (!advanced && f.it >= mol.nbrs[f.v].size()) {
                Frame done = stack.back();
                stack.pop_back();
                if (!stack.empty()) {
                    Frame& p = stack.back();
                    low[p.v] = std::min(low[p.v], low[done.v]);
                    if (low[done.v] > disc[p.v]) is_bridge[done.parent_bond] = 1;
                }
            }
        }
    }
    for (size_t bi = 0; bi < mol.bonds.size(); ++bi) {
        if (!is_bridge[bi]) {
            Bond& b = mol.bonds[bi];
            mol.atoms[b.a1].in_ring = true;
            mol.atoms[b.a2].in_ring = true;
            b.in_ring = true;
        }
    }
}

bool aromatic_path_exists(const Mol& mol, int bond_idx) {
    const Bond& b = mol.bonds[bond_idx];
    std::set<int> seen{b.a1};
    std::deque<int> queue{b.a1};
    while (!queue.empty()) {
        int v = queue.front();
        queue.pop_front();
        for (int nbi : mol.nbrs[v]) {
            if (nbi == bond_idx) continue;
            int u = mol.bonds[nbi].other(v);
            if (u == b.a2) return true;
            if (!seen.count(u) && mol.atoms[u].aromatic) {
                seen.insert(u);
                queue.push_back(u);
            }
        }
    }
    return false;
}

void upgrade_directional_ring_bonds(Mol& mol) {
    for (size_t bi = 0; bi < mol.bonds.size(); ++bi) {
        Bond& b = mol.bonds[bi];
        if (b.aromatic || b.order != 1 || !b.direction || !b.in_ring) continue;
        if (mol.atoms[b.a1].aromatic && mol.atoms[b.a2].aromatic &&
            aromatic_path_exists(mol, (int)bi))
            b.aromatic = true;
    }
}

// _implicit_hs (smiles.py): written-order H inference
int implicit_hs(const Mol& mol, int idx, int extra_sigma) {
    const Atom& a = mol.atoms[idx];
    auto valences = default_valences(a.symbol);
    if (valences.empty()) return 0;
    int sigma2 = 2 * extra_sigma;
    for (int bi : mol.nbrs[idx]) sigma2 += mol.bonds[bi].order2();
    int ev = (sigma2 + 1) / 2;  // int(sigma + 0.5) for half-integer sums
    if (a.aromatic) return std::max(0, valences[0] - ev);
    for (int v : valences)
        if (ev <= v) return v - ev;
    return 0;
}

int valence_shortfall(const Mol& mol, int idx, bool* known) {
    const Atom& a = mol.atoms[idx];
    auto valences = default_valences(a.symbol);
    if (valences.empty()) { *known = false; return 0; }
    *known = true;
    int dv = valences[0] + (early_element(a.symbol) ? -a.charge : a.charge);
    int sigma = a.total_hs();
    for (int bi : mol.nbrs[idx]) sigma += mol.bonds[bi].order;
    return dv - sigma;
}

// _electron_contribution: (electrons, partner) with DISQ=-1, partner -1
const int kDisq = -1;

void electron_contribution(const Mol& mol, int idx, int* electrons,
                           int* partner) {
    *partner = -1;
    const Atom& a = mol.atoms[idx];
    if (!pi_element(a.symbol)) { *electrons = kDisq; return; }
    bool any_arom = false;
    for (int bi : mol.nbrs[idx])
        if (mol.bonds[bi].aromatic) { any_arom = true; break; }
    if (any_arom) {
        bool known;
        int short_ = valence_shortfall(mol, idx, &known);
        if (known && short_ >= 1) { *electrons = 1; return; }
    }
    std::vector<int> multiple;
    for (int bi : mol.nbrs[idx])
        if (!mol.bonds[bi].aromatic && mol.bonds[bi].order >= 2)
            multiple.push_back(bi);
    bool has_triple = false;
    for (int bi : multiple)
        if (mol.bonds[bi].order >= 3) has_triple = true;
    if (multiple.size() >= 2 || has_triple) { *electrons = kDisq; return; }
    if (multiple.size() == 1) {
        *electrons = 1;
        *partner = mol.bonds[multiple[0]].other(idx);
        return;
    }
    int sigma = mol.degree(idx) + a.total_hs();
    const std::string& s = a.symbol;
    if (s == "C") {
        if (a.charge == -1 && sigma <= 3) { *electrons = 2; return; }
        if (a.charge == 1 && sigma <= 3) { *electrons = 0; return; }
        *electrons = kDisq;
        return;
    }
    if (s == "N" || s == "P" || s == "As") {
        if (a.charge == 0 && sigma <= 3) { *electrons = 2; return; }
        if (a.charge == -1 && sigma <= 2) { *electrons = 2; return; }
        if (a.charge == 1 && sigma <= 3) { *electrons = 0; return; }
        *electrons = kDisq;
        return;
    }
    if (s == "O" || s == "S" || s == "Se" || s == "Te") {
        if (a.charge == 0 && sigma <= 2) { *electrons = 2; return; }
        if (a.charge == 1 && sigma <= 2) { *electrons = 1; return; }
        *electrons = kDisq;
        return;
    }
    *electrons = kDisq;
}

struct Ring {
    std::set<int> atoms;
    std::set<int> bonds;
};

std::vector<Ring> smallest_rings(const Mol& mol) {
    std::map<std::set<int>, std::set<int>> rings;  // bonds -> atoms (dedup)
    std::vector<Ring> out;  // discovery order
    for (size_t bi = 0; bi < mol.bonds.size(); ++bi) {
        const Bond& b = mol.bonds[bi];
        if (!b.in_ring) continue;
        std::map<int, std::pair<int, int>> prev;  // atom -> (parent, bond)
        prev[b.a1] = {-1, -1};
        std::deque<int> queue{b.a1};
        bool reached = false;
        while (!queue.empty() && !reached) {
            int v = queue.front();
            queue.pop_front();
            for (int nbi : mol.nbrs[v]) {
                if (nbi == (int)bi || !mol.bonds[nbi].in_ring) continue;
                int u = mol.bonds[nbi].other(v);
                if (prev.count(u)) continue;
                prev[u] = {v, nbi};
                if (u == b.a2) { reached = true; break; }
                queue.push_back(u);
            }
        }
        if (!reached) continue;
        Ring r;
        r.bonds.insert((int)bi);
        int v = b.a2;
        while (v != -1) {
            r.atoms.insert(v);
            auto pr = prev[v];
            v = pr.first;
            if (pr.second != -1) r.bonds.insert(pr.second);
        }
        if (!rings.count(r.bonds)) {
            rings[r.bonds] = r.atoms;
            out.push_back(r);
        }
    }
    return out;
}

void aromatize(Mol& mol) {
    auto all_rings = smallest_rings(mol);
    std::vector<Ring> candidates;
    std::map<int, std::pair<int, int>> contrib;  // atom -> (e, partner)
    for (auto& ring : all_rings) {
        bool all_arom = true;
        for (int bi : ring.bonds)
            if (!mol.bonds[bi].aromatic) { all_arom = false; break; }
        if (all_arom) continue;
        bool disq = false;
        for (int i : ring.atoms) {
            if (!contrib.count(i)) {
                int e, p;
                electron_contribution(mol, i, &e, &p);
                contrib[i] = {e, p};
            }
            if (contrib[i].first == kDisq) disq = true;
        }
        if (disq) continue;
        candidates.push_back(ring);
    }
    if (candidates.empty()) return;

    const int kIncomplete = -2;
    auto evaluate = [&](const std::set<int>& atom_set) -> int {
        int total = 0;
        for (int i : atom_set) {
            auto [e, p] = contrib[i];
            if (e == 1 && p >= 0) {
                if (atom_set.count(p)) total += 1;
                else if (mol.atoms[p].in_ring) return kIncomplete;
                // else exocyclic: 0
            } else {
                total += e;
            }
        }
        return total;
    };
    auto mark = [&](const std::set<int>& ring_ids) {
        for (int ri : ring_ids) {
            for (int i : candidates[ri].atoms) mol.atoms[i].aromatic = true;
            for (int bi : candidates[ri].bonds) mol.bonds[bi].aromatic = true;
        }
    };

    int n_rings = (int)candidates.size();
    std::set<int> aromatic_rings;
    for (int ri = 0; ri < n_rings; ++ri) {
        int n = evaluate(candidates[ri].atoms);
        if (n >= 0 && n % 4 == 2) {
            mark({ri});
            aromatic_rings.insert(ri);
        }
    }
    std::vector<std::set<int>> adj(n_rings);
    for (int i = 0; i < n_rings; ++i)
        for (int j = i + 1; j < n_rings; ++j) {
            bool share = false;
            for (int bi : candidates[i].bonds)
                if (candidates[j].bonds.count(bi)) { share = true; break; }
            if (share) {
                adj[i].insert(j);
                adj[j].insert(i);
            }
        }
    int max_union = n_rings <= 20 ? 6 : 2;
    std::set<std::set<int>> frontier, seen;
    for (int ri = 0; ri < n_rings; ++ri) {
        frontier.insert({ri});
        seen.insert({ri});
    }
    for (int sz = 1; sz < max_union; ++sz) {
        std::set<std::set<int>> grown;
        for (const auto& group : frontier)
            for (int ri : group)
                for (int rj : adj[ri]) {
                    auto g = group;
                    g.insert(rj);
                    if (!seen.count(g)) {
                        seen.insert(g);
                        grown.insert(g);
                    }
                }
        for (const auto& group : grown) {
            bool all_done = true;
            for (int ri : group)
                if (!aromatic_rings.count(ri)) { all_done = false; break; }
            if (all_done) continue;
            std::set<int> atom_union;
            for (int ri : group)
                atom_union.insert(candidates[ri].atoms.begin(),
                                  candidates[ri].atoms.end());
            int n = evaluate(atom_union);
            if (n >= 0 && n % 4 == 2) {
                mark(group);
                for (int ri : group) aromatic_rings.insert(ri);
            }
        }
        frontier.swap(grown);
        if (frontier.empty()) break;
    }
}

void perceive(Mol& mol) {
    mark_rings(mol);
    upgrade_directional_ring_bonds(mol);
    for (size_t i = 0; i < mol.atoms.size(); ++i) {
        Atom& a = mol.atoms[i];
        if (a.explicit_hs >= 0) continue;
        a.implicit_hs = implicit_hs(mol, (int)i, a.merged_hs);
    }
    aromatize(mol);
}

Mol parse_smiles(const std::string& input) {
    std::string s = input;
    // strip ASCII whitespace (the Python spec strips the same explicit set)
    size_t b = s.find_first_not_of(" \t\r\n\v\f");
    if (b == std::string::npos) throw ParseError{"empty SMILES"};
    size_t e = s.find_last_not_of(" \t\r\n\v\f");
    s = s.substr(b, e - b + 1);

    Mol mol;
    std::vector<int> stack;
    int prev = -1;
    int pending_order = -2;  // -2 none, -1 aromatic ':', else order
    char pending_dir = 0;
    std::map<int, std::tuple<int, int, char>> ring_openings;
    size_t i = 0, n = s.size();

    auto add_atom = [&](Atom a) {
        int idx = (int)mol.atoms.size();
        mol.atoms.push_back(std::move(a));
        if (prev != -1) add_bond(mol, prev, idx, pending_order, pending_dir);
        prev = idx;
        pending_order = -2;
        pending_dir = 0;
    };
    auto ring_closure = [&](int num) {
        if (prev == -1) throw ParseError{"ring closure before any atom"};
        auto it = ring_openings.find(num);
        if (it != ring_openings.end()) {
            auto [start, open_order, open_dir] = it->second;
            ring_openings.erase(it);
            if (pending_order != -2 && open_order != -2 &&
                pending_order != open_order)
                throw ParseError{"ring closure bond order mismatch"};
            int order = pending_order != -2 ? pending_order : open_order;
            if (start == prev) throw ParseError{"ring bond to self"};
            for (const auto& bnd : mol.bonds)
                if ((bnd.a1 == start && bnd.a2 == prev) ||
                    (bnd.a1 == prev && bnd.a2 == start))
                    throw ParseError{"duplicate bond via ring closure"};
            add_bond(mol, start, prev, order,
                     pending_dir ? pending_dir : open_dir);
        } else {
            ring_openings[num] = {prev, pending_order, pending_dir};
        }
        pending_order = -2;
        pending_dir = 0;
    };

    while (i < n) {
        char c = s[i];
        if (c == '[') {
            auto [atom, next] = parse_bracket(s, i + 1);
            add_atom(atom);
            i = next;
        } else if (is_upper(c)) {
            std::string sym = s.substr(i, 1);
            if (i + 1 < n &&
                (s.substr(i, 2) == "Cl" || s.substr(i, 2) == "Br"))
                sym = s.substr(i, 2);
            if (!organic_subset(sym))
                throw ParseError{"element must be bracketed"};
            Atom a;
            a.symbol = sym;
            add_atom(a);
            i += sym.size();
        } else if (std::strchr("bcnops", c)) {
            Atom a;
            a.symbol = std::string{(char)std::toupper(c)};
            a.aromatic = true;
            add_atom(a);
            ++i;
        } else if (c == '*') {
            Atom a;
            a.symbol = "*";
            add_atom(a);
            ++i;
        } else if (std::strchr("-=#$:/\\", c)) {
            switch (c) {
                case '-': pending_order = 1; break;
                case '=': pending_order = 2; break;
                case '#': pending_order = 3; break;
                case '$': pending_order = 4; break;
                case ':': pending_order = -1; break;
                case '/': pending_order = 1; pending_dir = '/'; break;
                case '\\': pending_order = 1; pending_dir = '\\'; break;
            }
            ++i;
        } else if (is_digit(c)) {
            ring_closure(c - '0');
            ++i;
        } else if (c == '%') {
            if (i + 2 >= n || !is_digit(s[i + 1]) || !is_digit(s[i + 2]))
                throw ParseError{"bad %nn ring closure"};
            ring_closure((s[i + 1] - '0') * 10 + (s[i + 2] - '0'));
            i += 3;
        } else if (c == '(') {
            if (prev == -1) throw ParseError{"branch before any atom"};
            if (pending_order != -2)
                throw ParseError{"bond symbol before '('"};
            stack.push_back(prev);
            ++i;
        } else if (c == ')') {
            if (stack.empty()) throw ParseError{"unbalanced parentheses"};
            if (pending_order != -2)
                throw ParseError{"dangling bond symbol before ')'"};
            prev = stack.back();
            stack.pop_back();
            ++i;
        } else if (c == '.') {
            if (prev == -1) throw ParseError{"empty component before '.'"};
            if (pending_order != -2) throw ParseError{"bond symbol before '.'"};
            prev = -1;
            ++i;
        } else if (std::isspace((unsigned char)c)) {
            break;
        } else {
            throw ParseError{"unexpected character"};
        }
    }
    if (!ring_openings.empty()) throw ParseError{"unclosed ring bonds"};
    if (!stack.empty()) throw ParseError{"unclosed branch"};
    if (mol.atoms.empty()) throw ParseError{"no atoms in SMILES"};
    if (pending_order != -2)
        throw ParseError{"dangling bond symbol at end of SMILES"};
    mol.build_neighbors();
    merge_explicit_hydrogens(mol);
    perceive(mol);
    return mol;
}

// --------------------------------------------------------------- morgan

const uint32_t kM32Mask = 0xFFFFFFFFu;

inline uint32_t hash_combine32(uint32_t seed, uint32_t v) {
    return seed ^ (uint32_t)(v + 0x9E3779B9u + (seed << 6) + (seed >> 2));
}

uint32_t hash_range32(const std::vector<uint32_t>& vals) {
    uint32_t seed = 0;
    for (uint32_t v : vals) seed = hash_combine32(seed, v);
    return seed;
}

inline uint32_t hash_pair32(uint32_t a, uint32_t b) {
    return hash_combine32(hash_combine32(0, a), b);
}

int delta_mass(int z, int iso) {
    if (!iso) return 0;
    bool found;
    double mass = isotope_mass(z, iso, &found);
    if (!found) mass = (double)iso;
    double weight = atomic_weight(z);
    if (weight == 0.0) weight = (double)iso;
    return (int)(mass - weight);  // truncation toward zero
}

uint32_t connectivity_invariant(const Mol& mol, int idx) {
    const Atom& a = mol.atoms[idx];
    int hs = a.total_hs();
    int z = atomic_number(a.symbol);
    std::vector<uint32_t> comps{
        (uint32_t)z,
        (uint32_t)(mol.degree(idx) + hs),
        (uint32_t)hs,
        (uint32_t)a.charge & kM32Mask,
        (uint32_t)delta_mass(z, a.isotope) & kM32Mask,
    };
    if (a.in_ring) comps.push_back(1);
    return hash_range32(comps);
}

// environment bond-set as a dynamic bitset with big-endian-style ordering
// that matches Python int comparison (bit i = bond i)
struct BondSet {
    std::vector<uint64_t> w;  // little-endian words

    void set(int bit) {
        size_t word = bit / 64;
        if (w.size() <= word) w.resize(word + 1, 0);
        w[word] |= 1ull << (bit % 64);
    }
    void or_with(const BondSet& o) {
        if (o.w.size() > w.size()) w.resize(o.w.size(), 0);
        for (size_t i = 0; i < o.w.size(); ++i) w[i] |= o.w[i];
    }
    bool operator==(const BondSet& o) const {
        size_t m = std::max(w.size(), o.w.size());
        for (size_t i = 0; i < m; ++i) {
            uint64_t a = i < w.size() ? w[i] : 0;
            uint64_t b = i < o.w.size() ? o.w[i] : 0;
            if (a != b) return false;
        }
        return true;
    }
    bool operator<(const BondSet& o) const {  // numeric, like Python ints
        size_t m = std::max(w.size(), o.w.size());
        for (size_t i = m; i-- > 0;) {
            uint64_t a = i < w.size() ? w[i] : 0;
            uint64_t b = i < o.w.size() ? o.w[i] : 0;
            if (a != b) return a < b;
        }
        return false;
    }
};

void morgan_bits(const Mol& mol, int radius, int nbits, uint8_t* out_bits) {
    std::memset(out_bits, 0, (size_t)(nbits + 7) / 8);
    int n = (int)mol.atoms.size();
    if (n == 0) return;
    auto set_bit = [&](uint32_t invar) {
        uint32_t bit = invar % (uint32_t)nbits;
        out_bits[bit / 8] |= (uint8_t)(1u << (bit % 8));
    };
    std::vector<uint32_t> invariants(n);
    for (int i = 0; i < n; ++i) {
        invariants[i] = connectivity_invariant(mol, i);
        set_bit(invariants[i]);
    }
    std::vector<BondSet> neighborhoods;
    std::vector<BondSet> atom_nbhd(n);
    std::vector<char> dead(n, 0);

    std::vector<std::pair<int32_t, uint32_t>> nbrs;
    std::vector<int> live;  // atoms contributing this round, sorted later
    for (int layer = 0; layer < radius; ++layer) {
        auto round_inv = invariants;
        auto round_nbhd = atom_nbhd;
        live.clear();
        for (int i = 0; i < n; ++i) {
            if (dead[i]) continue;
            if (mol.degree(i) == 0) {
                dead[i] = 1;
                continue;
            }
            nbrs.clear();
            for (int bi : mol.nbrs[i]) {
                const Bond& bnd = mol.bonds[bi];
                int o = bnd.other(i);
                round_nbhd[i].set(bi);
                round_nbhd[i].or_with(atom_nbhd[o]);
                int32_t bt = bnd.aromatic ? 12 : bnd.order;
                nbrs.emplace_back(bt, invariants[o]);
            }
            std::sort(nbrs.begin(), nbrs.end());
            uint32_t invar = (uint32_t)layer;
            invar = hash_combine32(invar, invariants[i]);
            for (auto& [bt, nv] : nbrs)
                invar = hash_combine32(invar, hash_pair32((uint32_t)bt, nv));
            round_inv[i] = invar;
            live.push_back(i);
            for (auto& nb : neighborhoods)
                if (nb == round_nbhd[i]) {
                    dead[i] = 1;
                    break;
                }
        }
        // (env, invariant, atom) emission order without copying bond sets
        std::sort(live.begin(), live.end(), [&](int a, int b) {
            if (!(round_nbhd[a] == round_nbhd[b]))
                return round_nbhd[a] < round_nbhd[b];
            if (round_inv[a] != round_inv[b]) return round_inv[a] < round_inv[b];
            return a < b;
        });
        for (int i : live) {
            bool seen = false;
            for (auto& nb : neighborhoods)
                if (nb == round_nbhd[i]) {
                    seen = true;
                    break;
                }
            if (!seen) {
                set_bit(round_inv[i]);
                neighborhoods.push_back(round_nbhd[i]);
            }
        }
        invariants.swap(round_inv);
        atom_nbhd.swap(round_nbhd);
    }
}

// ------------------------------------------------------- canonical ranks

// keys live in one flat arena as (offset, length) spans: same comparison
// semantics as Python's tuple keys (lexicographic, shorter-prefix first)
// without per-key allocations
struct KeyArena {
    std::vector<int64_t> data;
    std::vector<std::pair<uint32_t, uint32_t>> spans;  // (offset, len)

    void clear() {
        data.clear();
        spans.clear();
    }
    void begin_key() { spans.emplace_back((uint32_t)data.size(), 0); }
    void push(int64_t v) {
        data.push_back(v);
        spans.back().second += 1;
    }
    bool less(int a, int b) const {
        auto [oa, la] = spans[a];
        auto [ob, lb] = spans[b];
        uint32_t m = std::min(la, lb);
        for (uint32_t i = 0; i < m; ++i) {
            if (data[oa + i] != data[ob + i]) return data[oa + i] < data[ob + i];
        }
        return la < lb;
    }
    bool equal(int a, int b) const {
        auto [oa, la] = spans[a];
        auto [ob, lb] = spans[b];
        if (la != lb) return false;
        for (uint32_t i = 0; i < la; ++i)
            if (data[oa + i] != data[ob + i]) return false;
        return true;
    }
};

std::vector<int> ranks_from_arena(const KeyArena& arena) {
    int n = (int)arena.spans.size();
    std::vector<int> idx(n);
    for (int i = 0; i < n; ++i) idx[i] = i;
    std::sort(idx.begin(), idx.end(),
              [&](int a, int b) { return arena.less(a, b); });
    std::vector<int> out(n);
    int rank = 0;
    for (int k = 0; k < n; ++k) {
        if (k > 0 && !arena.equal(idx[k - 1], idx[k])) ++rank;
        out[idx[k]] = rank;
    }
    return out;
}

std::vector<int> refine(const Mol& mol, std::vector<int> ranks) {
    int n = (int)mol.atoms.size();
    KeyArena arena;
    std::vector<std::pair<int, int>> neigh;
    for (int iter = 0; iter < n; ++iter) {
        arena.clear();
        for (int i = 0; i < n; ++i) {
            neigh.clear();
            for (int bi : mol.nbrs[i])
                neigh.emplace_back(mol.bonds[bi].order2(),
                                   ranks[mol.bonds[bi].other(i)]);
            std::sort(neigh.begin(), neigh.end());
            arena.begin_key();
            arena.push(ranks[i]);
            for (auto& [ov, r] : neigh) {
                arena.push(ov);
                arena.push(r);
            }
        }
        auto new_ranks = ranks_from_arena(arena);
        if (new_ranks == ranks) break;
        ranks = new_ranks;
    }
    return ranks;
}

std::vector<int> bfs_dists(const Mol& mol, int src) {
    int n = (int)mol.atoms.size();
    std::vector<int> dist(n, n + 1);
    dist[src] = 0;
    std::deque<int> queue{src};
    while (!queue.empty()) {
        int v = queue.front();
        queue.pop_front();
        for (int bi : mol.nbrs[v]) {
            int u = mol.bonds[bi].other(v);
            if (dist[u] > dist[v] + 1) {
                dist[u] = dist[v] + 1;
                queue.push_back(u);
            }
        }
    }
    return dist;
}

std::vector<int> canonical_ranks(const Mol& mol) {
    int n = (int)mol.atoms.size();
    KeyArena arena;
    for (int i = 0; i < n; ++i) {
        const Atom& a = mol.atoms[i];
        arena.begin_key();
        arena.push(atomic_number(a.symbol));
        arena.push(a.aromatic ? 1 : 0);
        arena.push(a.charge);
        arena.push(a.total_hs());
        arena.push(mol.degree(i));
        arena.push(a.in_ring ? 1 : 0);
        arena.push(a.isotope);
    }
    auto ranks = refine(mol, ranks_from_arena(arena));
    auto distinct = [&](const std::vector<int>& r) {
        std::set<int> s(r.begin(), r.end());
        return (int)s.size();
    };
    if (distinct(ranks) < n) {
        std::vector<int> counts(n, 0);
        for (int r : ranks) counts[r]++;
        arena.clear();
        std::vector<std::pair<int, int>> prof;
        for (int i = 0; i < n; ++i) {
            arena.begin_key();
            arena.push(ranks[i]);
            if (counts[ranks[i]] > 1) {
                auto dist = bfs_dists(mol, i);
                prof.clear();
                for (int j = 0; j < n; ++j)
                    if (j != i) prof.emplace_back(dist[j], ranks[j]);
                std::sort(prof.begin(), prof.end());
                // marker separating profiled from empty-profile keys: the
                // Python tuple () vs ((d, r), ...) comparison — a profiled
                // key is always "longer". Mirror by appending a flag first.
                arena.push(1);
                for (auto& [d, r] : prof) {
                    arena.push(d);
                    arena.push(r);
                }
            } else {
                arena.push(0);
            }
        }
        ranks = refine(mol, ranks_from_arena(arena));
    }
    while (distinct(ranks) < n) {
        std::vector<int> counts(n, 0);
        for (int r : ranks) counts[r]++;
        int dup_rank = -1;
        for (int r = 0; r < n; ++r)
            if (counts[r] > 1) { dup_rank = r; break; }
        int chosen = -1;
        for (int i = 0; i < n; ++i)
            if (ranks[i] == dup_rank) { chosen = i; break; }
        arena.clear();
        for (int i = 0; i < n; ++i) {
            arena.begin_key();
            arena.push(ranks[i]);
            arena.push(i == chosen ? 0 : 1);
        }
        ranks = refine(mol, ranks_from_arena(arena));
    }
    return ranks;
}

// --------------------------------------------------------------- writer

std::string atom_token(const Mol& mol, int i) {
    const Atom& a = mol.atoms[i];
    bool needs_bracket =
        (!organic_subset(a.symbol) && a.symbol != "*") || a.charge != 0 ||
        a.isotope != 0 || a.explicit_hs >= 0 ||
        implicit_hs(mol, i, 0) != a.total_hs();
    std::string sym = a.symbol;
    if (a.aromatic)
        for (auto& ch : sym) ch = (char)std::tolower(ch);
    if (!needs_bracket) return sym;
    int h = a.total_hs();
    std::string htxt = h == 0 ? "" : (h == 1 ? "H" : "H" + std::to_string(h));
    std::string ctxt;
    if (a.charge) {
        std::string sign = a.charge > 0 ? "+" : "-";
        int mag = std::abs(a.charge);
        ctxt = mag == 1 ? sign : sign + std::to_string(mag);
    }
    std::string iso = a.isotope ? std::to_string(a.isotope) : "";
    return "[" + iso + sym + htxt + ctxt + "]";
}

std::string bond_token(const Mol& mol, int bi) {
    const Bond& b = mol.bonds[bi];
    if (b.aromatic) return "";
    if (b.order == 1 && mol.atoms[b.a1].aromatic && mol.atoms[b.a2].aromatic)
        return "-";
    switch (b.order) {
        case 1: return "";
        case 2: return "=";
        case 3: return "#";
        default: return "$";
    }
}

std::string digit_txt(int d) {
    if (d < 10) return std::to_string(d);
    std::string out = "%";
    out += (char)('0' + d / 10);
    out += (char)('0' + d % 10);
    return out;
}

std::string write_smiles(const Mol& mol) {
    int n = (int)mol.atoms.size();
    if (n == 0) return "";
    auto ranks = canonical_ranks(mol);

    auto child_order = [&](int i) {
        auto order = mol.nbrs[i];
        std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
            int rx = ranks[mol.bonds[x].other(i)];
            int ry = ranks[mol.bonds[y].other(i)];
            if (rx != ry) return rx < ry;
            return x < y;
        });
        return order;
    };

    std::vector<char> visited(n, 0);
    std::vector<std::vector<std::pair<int, int>>> tree_children(n);
    std::vector<std::vector<int>> ring_bonds_at(n);
    std::vector<int> roots;
    std::vector<char> used_bond(mol.bonds.size(), 0);

    std::vector<int> root_order(n);
    for (int i = 0; i < n; ++i) root_order[i] = i;
    std::sort(root_order.begin(), root_order.end(), [&](int a, int b) {
        int da = std::min(mol.degree(a), 2), db = std::min(mol.degree(b), 2);
        if (da != db) return da < db;
        if (ranks[a] != ranks[b]) return ranks[a] < ranks[b];
        return a < b;
    });
    for (int root : root_order) {
        if (visited[root]) continue;
        roots.push_back(root);
        visited[root] = 1;
        struct Frame { int v; std::vector<int> order; size_t it; };
        std::vector<Frame> stack{{root, child_order(root), 0}};
        while (!stack.empty()) {
            Frame& f = stack.back();
            bool advanced = false;
            while (f.it < f.order.size()) {
                int bi = f.order[f.it++];
                if (used_bond[bi]) continue;
                used_bond[bi] = 1;
                int u = mol.bonds[bi].other(f.v);
                if (visited[u]) {
                    ring_bonds_at[f.v].push_back(bi);
                    ring_bonds_at[u].push_back(bi);
                } else {
                    visited[u] = 1;
                    tree_children[f.v].push_back({bi, u});
                    stack.push_back({u, child_order(u), 0});
                    advanced = true;
                }
                if (advanced) break;
            }
            if (!advanced && f.it >= f.order.size()) stack.pop_back();
        }
    }

    std::vector<int> digit_free;
    for (int d = 99; d >= 1; --d) digit_free.push_back(d);
    std::map<int, int> open_digits;

    // iterative emit matching the recursive Python structure
    std::string out_all;
    for (size_t r = 0; r < roots.size(); ++r) {
        if (r) out_all += ".";
        struct EFrame {
            int i;
            size_t child;
            std::string out;
        };
        std::vector<EFrame> stk{{roots[r], 0, ""}};
        // first-visit work for root
        auto first_visit = [&](EFrame& f) {
            f.out += atom_token(mol, f.i);
            for (int bi : ring_bonds_at[f.i]) {
                auto it = open_digits.find(bi);
                if (it != open_digits.end()) {
                    int digit = it->second;
                    open_digits.erase(it);
                    digit_free.push_back(digit);
                    f.out += bond_token(mol, bi) + digit_txt(digit);
                } else {
                    if (digit_free.empty())
                        throw ParseError{
                            "more than 99 ring closures open at once"};
                    int digit = digit_free.back();
                    digit_free.pop_back();
                    open_digits[bi] = digit;
                    f.out += bond_token(mol, bi) + digit_txt(digit);
                }
            }
        };
        first_visit(stk[0]);
        std::string result;
        while (!stk.empty()) {
            EFrame& f = stk.back();
            auto& children = tree_children[f.i];
            if (f.child < children.size()) {
                auto [bi, j] = children[f.child];
                EFrame nf{j, 0, ""};
                first_visit(nf);
                stk.push_back(std::move(nf));
            } else {
                // done: pop and append into parent
                EFrame done = std::move(stk.back());
                stk.pop_back();
                if (stk.empty()) {
                    result = std::move(done.out);
                } else {
                    EFrame& p = stk.back();
                    auto [bi, j] = tree_children[p.i][p.child];
                    (void)j;
                    std::string sub = bond_token(mol, bi) + done.out;
                    if (p.child < tree_children[p.i].size() - 1)
                        p.out += "(" + sub + ")";
                    else
                        p.out += sub;
                    p.child += 1;
                }
            }
        }
        out_all += result;
    }
    return out_all;
}

}  // namespace

// ------------------------------------------------------------ C interface

extern "C" {

// SMILES -> packed Morgan fingerprint + canonical SMILES.
// Returns the canonical SMILES length (>= 0) on success, -1 on parse error,
// -2 if the canonical SMILES doesn't fit in canon_cap.
// out_fp must hold nbits/8 bytes; bit i -> byte i/8 bit i%8 (RDKit layout).
long tsn_smiles_fingerprint(const char* smiles, int radius, int nbits,
                            uint8_t* out_fp, char* out_canon,
                            long canon_cap) {
    try {
        Mol mol = parse_smiles(smiles);
        morgan_bits(mol, radius, nbits, out_fp);
        std::string canon = write_smiles(mol);
        if ((long)canon.size() >= canon_cap) return -2;
        std::memcpy(out_canon, canon.data(), canon.size());
        out_canon[canon.size()] = 0;
        return (long)canon.size();
    } catch (const ParseError&) {
        return -1;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
